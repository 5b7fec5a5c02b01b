"""BENCHMARK.json against the benchmark's contract, and every file a cell
names there."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness as H

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                   r"features|_dim$|_rank$|expansion|per_tok)")


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert isinstance(MANIFEST["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", MANIFEST["configs"] + MANIFEST["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_text(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])


def test_names_unique():
    for group in (MANIFEST["configs"], MANIFEST["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cfg", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["source"] == cfg["source"]
    assert len(cfg["reduced"]) <= 16
    for key in cfg["reduced"]:
        assert NAME.match(key) and not WIDTH.search(key)
    assert any(w["config"] == cfg["name"] for w in MANIFEST["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_and_metrics(cell):
    w = next(x for x in MANIFEST["workloads"] if x["name"] == cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1
    c = H.load_cell(cell)
    assert c.traffic["path"] in ("fused_chain", "chain_farm",
                                 "compiled_chain")
    c.module("paths", c.traffic["path"])
    c.module("models", c.config["model"])
    assert c.counts() is not None
    assert c.limits, "every cell's check has limits"
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (ROOT / "benchmark" / "metrics" / f"{metric['name']}.py").exists()
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if metric in MANIFEST["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in {m["name"] for m in MANIFEST["end_to_end"]}
        moved = next(m for m in MANIFEST["end_to_end"]
                     if m["name"] == metric["moves"])
        for cell in metric["workloads"]:
            assert cell in moved.get("workloads", CELLS)
        if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
            assert metric["unit"] == "%"


def test_layers_are_named_alike():
    layers = {m["name"]: m["layer"] for m in MANIFEST["per_layer"]}
    assert layers["kernels_per_superstep"] == layers["superstep_rest_us"]


def test_files_under_paths_are_named_from_name_characters():
    for f in (ROOT / "benchmark").rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            rel = f.relative_to(ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
