"""The port's experiments (time_analysis, cores_sweep), its recorder and
its CLI against pmpx's: the same keys and per-cell paths on the CPU; and
the rule that no module of the port imports JAX or pmpx, shown by
importing every one of them with both blocked."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pmpx.experiments import cores_sweep as jcores  # noqa: E402
from pmpx.experiments import time_analysis as jtime  # noqa: E402
from pmpx.metrics import recorder as jrec  # noqa: E402
from pmpx_torch import cli  # noqa: E402
from pmpx_torch.experiments import EXPERIMENTS  # noqa: E402
from pmpx_torch.experiments import _common  # noqa: E402
from pmpx_torch.experiments import cores_sweep as tcores  # noqa: E402
from pmpx_torch.experiments import time_analysis as ttime  # noqa: E402
from pmpx_torch.metrics import recorder as trec  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIME_KW = dict(data_sizes=(500,), Ps=(4,), iters=4, include_conv_pmp=True)
CORES_KW = dict(n_data=256, Ps=(8,), set_time=0.5, chunk=16,
                fused_call_steps=16)


def _method_values(out):
    return {k: v for k, v in out.items() if k.endswith("_method")}


@pytest.mark.parametrize("method", ["fused_chain", "sweep"])
def test_time_analysis_keys_and_paths_match_pmpx(method, tmp_path):
    want = jtime.run(**TIME_KW, method=method, out_dir=str(tmp_path / "j"))
    got = ttime.run(**TIME_KW, method=method, out_dir=str(tmp_path / "t"),
                    device="cpu")
    assert set(got) == set(want)
    assert _method_values(got) == _method_values(want)
    if method == "fused_chain":
        assert set(_method_values(got).values()) == {"fused_chain"}
        assert got["fused_eligibility"] == want["fused_eligibility"]
    for k, v in got.items():
        if k.endswith("_us") and not k.endswith("overhead_us"):
            assert np.isfinite(v) and v > 0
    saved = json.loads((tmp_path / "t" / "time_analysis.json").read_text())
    assert saved["device"] == "cpu"
    assert saved["rows"] == json.loads(
        (tmp_path / "j" / "time_analysis.json").read_text())["rows"]
    assert ttime.REFERENCE_A100 == jtime.REFERENCE_A100


def test_time_analysis_falls_back_where_unsupported(tmp_path):
    """P = 2048 is beyond the kernel: both packages time those cells on
    the scan path and say so, and keep the P = 8 cells fused."""
    kw = dict(data_sizes=(500,), Ps=(8, 2048), iters=2,
              method="fused_chain")
    want = jtime.run(**kw, out_dir=str(tmp_path / "j"))
    got = ttime.run(**kw, out_dir=str(tmp_path / "t"), device="cpu")
    assert _method_values(got) == _method_values(want) == {
        "mp_n500_P8_method": "fused_chain",
        "mp_n500_P2048_method": "scan",
        "pmp_n500_P8_method": "fused_chain",
        "pmp_n500_P2048_method": "scan",
    }


def test_time_analysis_rejects_other_scales(tmp_path):
    with pytest.raises(ValueError, match="smoke"):
        ttime.run(data_sizes=(500,), Ps=(4,), iters=2, scale="paper",
                  out_dir=str(tmp_path), device="cpu")


@pytest.mark.parametrize("algo", ["pmp", "mp"])
@pytest.mark.parametrize("method", ["fused_chain", "auto"])
def test_cores_sweep_keys_match_pmpx(algo, method, tmp_path):
    want = jcores.run(**CORES_KW, algo=algo, method=method,
                      out_dir=str(tmp_path / "j"))
    got = tcores.run(**CORES_KW, algo=algo, method=method,
                     out_dir=str(tmp_path / "t"), device="cpu")
    assert set(got) == set(want)
    assert got["P8_iters"] > 0 and np.isfinite(got["P8_err"])
    tail = trec.load_trace(str(tmp_path / "t" / f"cores_{algo}.npz"))
    assert tail["P8_tail"].shape[1] == 3


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttime.run(data_sizes=(500,), Ps=(4,), iters=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcores.run(n_data=64, Ps=(4,), set_time=0.1)


def test_recorder_matches_pmpx(tmp_path):
    for args in [("PMP", 0.5, 1000), ("MP", 1.0, 20, "_FC", 7),
                 ("MH", 2, 5, "", 0)]:
        assert trec.reference_style_name(*args) == \
            jrec.reference_style_name(*args)
    arrays = {"a": np.arange(6.0).reshape(2, 3), "b": np.ones(4, np.int32)}
    p = trec.save_trace(str(tmp_path), "x", arrays, {"k": 1})
    back = jrec.load_trace(p)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
    meta = json.loads((tmp_path / "x.json").read_text())
    assert meta["k"] == 1 and meta["arrays"] == {"a": [2, 3], "b": [4]}


def test_common_helpers():
    from pmpx_torch.samplers import pmp

    assert _common.as_tuple(4) == (4,)
    assert _common.as_tuple([4, 16]) == (4, 16)
    assert _common.as_tuple((1,)) == (1,)
    from pmpx_torch.interop import linreg_from_numpy

    x = np.linspace(-1, 1, 64, dtype=np.float32)
    tt = linreg_from_numpy(x, -1 + 2 * x, temper=0.1, device="cpu")
    sup = pmp.make_superstep(tt, pmp.PMPConfig(N=1, depth=2, step_size=0.1))
    g = torch.Generator()
    g.manual_seed(0)
    s = _common.collect_samples(sup, g, torch.tensor([0.0, 0.0, 1.0]), 10)
    assert isinstance(s, np.ndarray) and s.shape == (32, 3)  # 40 - 20%
    assert _common.maybe_plot(lambda plt: 7) in (7, None)


def test_cli_list_and_run(tmp_path, capsys):
    assert EXPERIMENTS == ["cores_sweep", "ess_msjd", "time_analysis"]
    assert cli.main(["list"]) == 0
    listed = capsys.readouterr().out.split()
    assert "time_analysis" in listed and "cores_sweep" in listed
    assert "ess_msjd" in listed
    assert cli.main([
        "run", "time_analysis", "--method", "fused_chain",
        "--include_conv_pmp", "true", "--data_sizes", "500", "--Ps", "4",
        "--iters", "2", "--out-dir", str(tmp_path), "--device", "cpu",
    ]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["pmp_general_N7_D3_n500_P512_method"] == "fused_chain"
    assert out["mp_n500_P4_method"] == "fused_chain"
    assert cli._parse_value("4,16") == (4, 16)
    assert cli._parse_value("true") is True
    assert cli._parse_value("0.5") == 0.5
    with pytest.raises(SystemExit):
        cli.main(["run", "time_analysis", "--iters"])
    with pytest.raises(SystemExit):
        cli.main(["run", "no_such_experiment"])


def test_cli_runs_as_a_module(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "pmpx_torch.cli", "run", "cores_sweep",
         "--method", "fused_chain", "--algo", "mp", "--n_data", "128",
         "--Ps", "4", "--set_time", "0.2", "--chunk", "8",
         "--fused_call_steps", "8", "--out_dir", str(tmp_path),
         "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT)),
    )
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout)["P4_iters"] > 0


_BLOCKED = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "pmpx"):
    sys.modules[name] = None  # any import of these now raises
import pmpx_torch
mods = ["pmpx_torch"] + [m.name for m in pkgutil.walk_packages(
    pmpx_torch.__path__, "pmpx_torch.")]
for m in mods:
    importlib.import_module(m)
sys.path.insert(0, sys.argv[1])
importlib.import_module("chip_smoke")
print(len(mods))
"""


def test_every_port_module_imports_with_jax_and_pmpx_blocked():
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED, str(ROOT)], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    n = int(res.stdout.split()[-1])
    want = len(list((ROOT / "pmpx_torch").rglob("*.py")))
    assert n == want  # every module (packages by their __init__)
