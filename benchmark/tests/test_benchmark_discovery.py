"""A cell added as files is found by name, with no edit of the harness."""

import json
import shutil
from pathlib import Path

import torch

from benchmark import harness as H
from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parents[2]


def test_added_cell_is_found_and_runs(tmp_path):
    bench = tmp_path / "benchmark"
    for sub in ("configs", "limits", "traffic"):
        shutil.copytree(ROOT / "benchmark" / sub, bench / sub)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["workloads"].append({
        "name": "linreg-p1024-fused-chunk500",
        "config": "linreg-n100k-pmp1024", "traffic": "fused-chunk500",
        "chips": 1, "why": "the one-chain cell at launches of 500"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    traffic = json.loads((bench / "traffic" / "fused-one-chain.json")
                         .read_text())
    traffic["chunk"] = 500
    (bench / "traffic" / "fused-chunk500.json").write_text(
        json.dumps(traffic))
    shutil.copy(bench / "limits" / "linreg-p1024-fused.json",
                bench / "limits" / "linreg-p1024-fused-chunk500.json")
    cell = H.load_cell("linreg-p1024-fused-chunk500", root=tmp_path)
    assert cell.traffic["chunk"] == 500
    assert {m["name"] for m in cell.end_to_end} == {"supersteps_per_s",
                                                    "setup_s"}
    ov = {"config": tiny.LINREG["config"],
          "traffic": {"chunk": 100, "burn_in_launches": 2}}
    out = H.run_cell(cell, 7, 1.0, False, torch.device("cpu"),
                     overrides=ov)
    assert out["result"]["attempted"] % 100 == 0
    assert out["result"]["correct"]
