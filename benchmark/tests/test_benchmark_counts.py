"""The counts of operations and bytes against formulas worked out by hand,
at a small shape and at the configurations' own."""

import json
from pathlib import Path

import pytest

from benchmark import harness as H

ROOT = Path(__file__).resolve().parents[2]


def _counts(config):
    return H.load_cell(next(
        w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())
        ["workloads"] if w["config"] == config)).counts()


def _linreg(n, depth):
    return {"n_data": n, "sampler": {"depth": depth}}


@pytest.mark.parametrize("n,depth", [(10, 1), (100_000, 10)])
def test_rss_call(n, depth):
    c = _counts("linreg-n100k-pmp1024")
    P = 2 ** depth
    flops, nbytes = c.rss_call(_linreg(n, depth))
    assert flops == 5 * P * n
    assert nbytes == 4 * (2 * n + 3 * P)


@pytest.mark.parametrize("n,depth,chunk,chains",
                         [(10, 1, 2, 1), (100_000, 10, 1000, 1),
                          (100_000, 10, 1000, 132)])
def test_chain_launch(n, depth, chunk, chains):
    c = _counts("linreg-n100k-pmp1024")
    P = 2 ** depth
    per_node = 3 + 3 * depth / 2 + 6 + 5 * depth + 5 + 14
    flops, nbytes = c.chain_launch(_linreg(n, depth), chunk, chains)
    assert flops == pytest.approx(chains * chunk * P * per_node + 8 * n)
    assert nbytes == 4 * (2 * n + chains * (4 * chunk + 6))


def test_linreg_superstep_by_path():
    c = _counts("linreg-n100k-pmp1024")
    cfg = _linreg(100_000, 10)
    sweep, _ = c.superstep(cfg, {"path": "compiled_chain"})
    assert sweep == pytest.approx(5 * 1024 * 100_000 + 1024 * 79)
    fused, _ = c.superstep(cfg, {"path": "fused_chain", "chunk": 1000})
    assert fused == pytest.approx(1024 * 93 + 800)
    farm, _ = c.superstep(cfg, {"path": "chain_farm", "chunk": 1000,
                                "chains": 132})
    assert farm == pytest.approx(1024 * 93 + 800 / 132)


@pytest.mark.parametrize("B,N", [(1, 1), (60_000, 7)])
def test_lstm_call(B, N):
    c = _counts("mnist-lstm-pmp8")
    cfg = {"rows": 28, "features": 28, "hidden": 64, "classes": 10,
           "n_train": B, "sampler": {"N": N}}
    P = N + 1
    flops, nbytes = c.lstm_call(cfg)
    assert flops == 2 * (28 + 64) * 256 * 28 * B * P
    assert nbytes == 4 * (B * 28 * 28 + P * (92 * 256 + 256) + P * B * 64)
    total, _ = c.superstep(cfg, {})
    assert total == flops + P * B * (2 * 64 * 10 + 40)


def test_lstm_call_at_the_configuration():
    cell = H.load_cell("mnist-lstm-pmp")
    flops, _ = cell.counts().lstm_call(cell.config)
    assert flops == pytest.approx(633.0778e9, rel=1e-6)
