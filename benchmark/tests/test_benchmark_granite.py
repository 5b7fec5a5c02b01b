"""The granite-4.0-h-micro cell's files: found by name with no edit of the
harness, its counts against formulas worked out by hand at the tiny size
and at the configuration's own, its path's records, its reference
independent of the program, and the cell rehearsed on the CPU at the tiny
size through the plain versions."""

import json
import math
from pathlib import Path

import pytest
import torch

from benchmark import harness as H
from benchmark.tests.test_benchmark_imports import _imports

ROOT = Path(__file__).resolve().parents[2]
CELL = "granite-h-micro-pmp"
TINY = {"hidden_size": 64, "num_hidden_layers": 3,
        "layer_types": ["mamba", "attention", "mamba"], "vocab_size": 97,
        "mamba_n_heads": 4, "mamba_d_head": 16, "mamba_d_state": 8,
        "mamba_expand": 1, "num_attention_heads": 4,
        "num_key_value_heads": 2, "shared_intermediate_size": 128,
        "sequences": 2, "seq_len": 33, "dtype": "float32"}


def _tiny(cell):
    from benchmark.reference import granite_hybrid as ref

    cfg = dict(cell.config, **TINY)
    cfg["params"] = sum(math.prod(s) for _, s, _ in ref.layout(cfg))
    return cfg


def test_cell_files_are_found():
    cell = H.load_cell(CELL)
    assert cell.config["model"] == "granite_hybrid"
    assert cell.traffic["path"] == "compiled_chain_thin"
    for kind, name in (("models", "granite_hybrid"),
                       ("paths", "compiled_chain_thin"),
                       ("reference", "granite_hybrid"),
                       ("metrics", "ssd_roofline"),
                       ("metrics", "lm_rest_us"),
                       ("metrics", "tree_positions_inplace_roofline")):
        cell.module(kind, name)
    assert hasattr(cell.counts(), "ssd_call")
    assert hasattr(cell.counts(), "positions_call")
    assert set(cell.limits) == {"logp_gap", "stay_share", "select_z"}
    assert {m["name"] for m in cell.end_to_end} == {"supersteps_per_s",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "mfu", "kernels_per_superstep", "outside_chain_pct",
        "launch_host_us", "capture_s", "ssd_roofline", "lm_rest_us",
        "tree_positions_inplace_roofline"}


def test_configuration_keeps_the_catalog_numbers():
    cfg = H.load_cell(CELL).config
    assert (cfg["num_hidden_layers"], cfg["vocab_size"]) == (10, 12544)
    assert cfg["published"] == {"num_hidden_layers": 40,
                                "vocab_size": 100352}
    assert len(cfg["layer_types"]) == 40
    assert cfg["layer_types"][:10].count("attention") == 1
    assert cfg["params"] == 772_160_448


@pytest.mark.parametrize("which", ["tiny", "configuration"])
def test_counts_match_their_formula(which):
    cell = H.load_cell(CELL)
    cfg = _tiny(cell) if which == "tiny" else cell.config
    c = cell.counts()
    H_, V, I = (cfg["hidden_size"], cfg["vocab_size"],
                cfg["shared_intermediate_size"])
    nh, hd, N = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"]
    nq, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    ahd = H_ // nq
    P, S, T = 8, cfg["sequences"], cfg["seq_len"]
    kinds = cfg["layer_types"][:cfg["num_hidden_layers"]]
    m, a = kinds.count("mamba"), kinds.count("attention")
    tok = P * S * T
    ssd_f = 5 * hd * N * nh * tok
    ssd_b = tok * (2 * 2 * nh * hd + 2 * 2 * N + 4 * nh) + P * S * nh * 8
    if which == "tiny":  # float32
        ssd_b = tok * (4 * 2 * nh * hd + 4 * 2 * N + 4 * nh) + P * S * nh * 8
    assert c.ssd_call(cfg) == (pytest.approx(ssd_f), pytest.approx(ssd_b))
    di = nh * hd
    proj = (m * 2 * H_ * (di + di + 2 * N + nh) + m * 2 * di * H_
            + a * 2 * H_ * (2 * nq * ahd + 2 * nkv * ahd)
            + len(kinds) * 2 * 3 * H_ * I + 2 * H_ * V + 4 * V)
    attn = a * P * S * 4 * nq * ahd * T * (T + 1) / 2
    flops, nbytes = c.superstep(cfg, {})
    assert flops == pytest.approx(tok * proj + attn + m * ssd_f)
    e = 4 if which == "tiny" else 2
    assert nbytes == pytest.approx(P * cfg["params"] * e + S * (T + 1) * 8
                                   + m * ssd_b)


def test_counts_at_the_configuration():
    cell = H.load_cell(CELL)
    flops, _ = cell.counts().superstep(cell.config, {})
    assert flops == pytest.approx(207.643e12, rel=1e-5)
    assert cell.counts().ssd_call(cell.config)[0] == pytest.approx(
        343.597e9, rel=1e-5)


def test_reference_imports_neither_the_program_nor_jax():
    path = ROOT / "benchmark" / "reference" / "granite_hybrid.py"
    assert not set(_imports(path)) & {"pmpx_torch", "pmpx", "jax", "jaxlib",
                                      "flax"}


def test_cell_rehearses_on_the_cpu():
    cell = H.load_cell(CELL)
    ov = {"config": _tiny(cell),
          "traffic": {"steps_per_launch": 2, "check_states": 3,
                      "watch": 512}}
    out = H.run_cell(cell, 2**31 + 3, 1.0, False, torch.device("cpu"),
                     overrides=ov)
    res, o = out["result"], out["outputs"]
    assert res["correct"] and res["failed"] == 0
    steps = res["attempted"]
    assert o["draws"].shape == (1, steps, 512)
    assert o["logp"].shape == (1, steps) and o["log_accept"].shape == (
        1, steps, 8)
    # the window's first two launches' states and its last
    assert len(o["states"]) == min(3, steps // 2)
    assert o["states"][-1].shape == (ov["config"]["params"],)


def test_new_metrics_read_nothing_without_a_trace():
    cell = H.load_cell(CELL)
    rec = {"config": cell.config, "counts": cell.counts(), "peaks": None,
           "segment": None}
    new = ("ssd_roofline", "lm_rest_us", "tree_positions_inplace_roofline")
    for name in new:
        assert cell.module("metrics", name).read(rec) is None
    rec = dict(rec, counts=None)
    for name in new:
        assert cell.module("metrics", name).read(rec) is None


def test_lm_rest_us_leaves_out_the_products():
    cell = H.load_cell(CELL)
    seg = {"supersteps": 2, "ops": [
        ("mamba2_ssd_kernel", 100.0, 0.0, "kernel"),
        ("sm90_xmma_gemm_bf16bf16_bf16f32", 50.0, 1.0, "kernel"),
        ("nvjet_tst_128x256", 50.0, 2.0, "kernel"),
        ("pytorch_flash::flash_fwd_kernel", 70.0, 3.0, "kernel"),
        ("vectorized_elementwise_kernel", 30.0, 4.0, "kernel"),
        ("tree_select_kernel", 10.0, 5.0, "kernel"),
        ("Memcpy DtoD", 99.0, 6.0, "gpu_memcpy")]}
    rec = {"config": cell.config, "counts": cell.counts(), "segment": seg,
           "peaks": json.loads((ROOT / "benchmark" / "peaks.json")
                               .read_text())["cards"][0]}
    assert cell.module("metrics", "lm_rest_us").read(rec) == 20.0
    f, b = cell.counts().ssd_call(cell.config)
    want = 100 * max(f / 989e12, b / 3.35e12) / 100e-6
    assert cell.module("metrics", "ssd_roofline").read(rec) == \
        pytest.approx(want)


def test_positions_roofline_reads_the_in_place_kernel_alone():
    cell = H.load_cell(CELL)
    seg = {"supersteps": 2, "ops": [
        ("tree_positions_inplace_kernel(float const*, float*)", 20e3, 0.0,
         "kernel"),
        ("tree_positions_inplace_kernel(float const*, float*)", 30e3, 1.0,
         "kernel"),
        ("tree_positions_kernel(float const*)", 1.0, 2.0, "kernel"),
        ("tree_select_kernel", 10.0, 3.0, "kernel")]}
    rec = {"config": cell.config, "counts": cell.counts(), "segment": seg,
           "peaks": json.loads((ROOT / "benchmark" / "peaks.json")
                               .read_text())["cards"][0]}
    f, b = cell.counts().positions_call(cell.config)
    # P = 8 rows over d = 772,160,448: eps read and written, theta read
    assert b == 17 * 772_160_448 * 4 and f == 3 * 8 * 772_160_448
    want = 100 * max(f / 989e12, b / 3.35e12) / 25e-3
    got = cell.module("metrics", "tree_positions_inplace_roofline").read(rec)
    assert got == pytest.approx(want)
    assert 50.0 < got < 100.0  # 15.7 ms of bytes over a 25 ms mean
