"""Each cell end to end on the CPU at the test's sizes, through the plain
versions of the program's kernels: the run completes, is correct, and
prints no device metric (a CPU run has none)."""

import json

import pytest
import torch

from benchmark import harness as H
from benchmark.tests import tiny

CELLS = [w["name"] for w in json.loads(
    (H.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_cpu(name):
    cell = H.load_cell(name)
    out = H.run_cell(cell, 2**31 + 99, 1.0, False, torch.device("cpu"),
                     overrides=tiny.overrides(name))
    res = out["result"]
    assert res["correct"], res["check"]
    assert res["metrics"] == {}
    assert res["device"]["platform"] == "cpu"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "check"
    assert set(res["check"]) == set(cell.limits)
    assert set(out["split"]) == {"import_s", "cuda_init_s", "library_s",
                                 "data_s", "warm_up_s"}


def test_same_seed_same_inputs():
    cell = H.load_cell("mnist-lstm-pmp")
    model = cell.module("models", "mnist_lstm")
    cfg = dict(cell.config, n_train=32)
    a, b = (model.inputs(cfg, 2**31 + 3, "cpu") for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = model.inputs(cfg, 2**31 + 4, "cpu")
    assert not torch.equal(a["X"], c["X"])


def test_result_line_is_json_with_infinities_capped():
    line = H._finite({"check": {"moment_z": {"value": float("inf"),
                                             "limit": 10.0}}})
    assert json.loads(json.dumps(line, allow_nan=False))[
        "check"]["moment_z"]["value"] == 1e300
