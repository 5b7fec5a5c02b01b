"""The command itself: it refuses to run without the card a cell needs,
printing no result, and a directory with the benchmark's files alone
cannot run a cell."""

import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness as H

CMD = ["benchmark/run.py", "--workload", "linreg-p1024-fused", "--seed",
       "2147483659", "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, *CMD], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(H.ROOT)
    assert p.returncode != 0
    assert p.stdout == ""
    assert "CUDA" in p.stderr


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(H.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(H.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert p.stdout == ""


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        H.load_cell("no-such-cell")
