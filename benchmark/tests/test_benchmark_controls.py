"""The controls fail the check: the reference's sampler in bfloat16 in a
linreg cell's place, and the LSTM cell's program with its bfloat16 path
on.  On the CPU at the test's sizes; on a card at the cells' own sizes."""

import json

import pytest
import torch

from benchmark import controls
from benchmark import harness as H
from benchmark.tests import tiny

CELLS = [w["name"] for w in json.loads(
    (H.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _fails(cell, numbers):
    return any(v > cell.limits[k]["limit"] for k, v in numbers.items())


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_cpu(name):
    cell = H.load_cell(name)
    numbers = controls.control(cell, 2**31 + 11, torch.device("cpu"), 1.0,
                               overrides=tiny.overrides(name))
    assert _fails(cell, numbers), numbers


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(cuda, name):
    cell = H.load_cell(name)
    for seed in (11, 2**31 + 99, 987654321):
        numbers = controls.control(cell, seed, cuda)
        assert _fails(cell, numbers), (seed, numbers)
