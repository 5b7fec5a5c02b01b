"""The benchmark's own tests.  They import the harness from the repo root
and never JAX; the tests that need a card carry the ``gpu`` marker and
skip without one."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips without one)")
