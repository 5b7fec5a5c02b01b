"""Nothing under benchmark/ imports JAX, flax or the JAX package (top-level
names compared whole: pmpx_torch is the program, pmpx is not), and the
reference imports nothing of the program."""

import ast
import sys
from pathlib import Path

import pytest

from benchmark import harness as H

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_nor_jax_package(path):
    assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "pmpx"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "pmpx_torch" not in set(_imports(path))


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pmpx_torchlike", sys)
    assert H.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pmpx.samplers", sys)
    assert H.forbidden_modules() == ["pmpx.samplers"]
