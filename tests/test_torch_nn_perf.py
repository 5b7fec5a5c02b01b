"""``nn_perf``, ``profiling`` and ``transport`` of pmpx_torch on the CPU:
the table and the bf16 studies as smoke runs at small sizes beside pmpx's
cells, the incremental JSON, ``footprint``'s refusal without a card, the
profiler trace and timer, the bounded device probe and the CLI's
``doctor``."""

import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pmpx.experiments import nn_perf as jperf  # noqa: E402
from pmpx_torch import cli, profiling, transport  # noqa: E402
from pmpx_torch.experiments import nn_perf  # noqa: E402
from pmpx_torch.kernels import launches  # noqa: E402

SMALL = dict(n_mnist=32, n_cifar=16, device="cpu")
ALL_CELLS = [f"mnist_{m}_{a}{s}" for m, s in (
    ("FC", ""), ("CNN", ""), ("CNN", "_packed"), ("LSTM", ""))
    for a in ("mh", "mp", "pmp")] + [
    f"cifar_{a}{s}" for s in ("", "_packed")
    for a in ("sp_hmc", "mp_hmc", "pmp_hmc")]


def test_table_names_the_cells_of_pmpx(monkeypatch):
    """Every cell of pmpx's table, by name, in its order (pmpx's cells
    recorded without timing them)."""
    names = []
    monkeypatch.setattr(jperf, "_time_cell", lambda target, spec, iters: 1.0)
    want = jperf.table(iters=1, n_mnist=16, n_cifar=16,
                       on_cell=lambda n, v: names.append(n))
    assert names == list(want) == ALL_CELLS


@pytest.mark.parametrize("only", ["mnist_CNN_*", "cifar_sp_hmc*",
                                  "mnist_FC_mh,mnist_LSTM_pmp"])
def test_table_smoke_on_the_cpu(only):
    """Each selected cell times a positive µs per superstep; nothing
    launches a kernel on the CPU."""
    seen = []
    before = dict(launches)
    cells = nn_perf.table(iters=2, only=only, **SMALL,
                          on_cell=lambda n, v: seen.append(n))
    assert launches == before
    pats = only.split(",")
    from fnmatch import fnmatch
    want = [n for n in ALL_CELLS if any(fnmatch(n, p) for p in pats)]
    assert list(cells) == seen == want
    for name, v in cells.items():
        assert isinstance(v, float) and v > 0, (name, v)


def test_table_records_a_failed_cell_and_goes_on(monkeypatch):
    def boom(target, spec, iters):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(nn_perf, "_time_cell", boom)
    cells = nn_perf.table(iters=1, only=("mnist_FC_mh", "mnist_FC_mp"),
                          **SMALL)
    assert cells == {"mnist_FC_mh": "error: out of memory",
                     "mnist_FC_mp": "error: out of memory"}


def test_bf16_delta_smoke_on_the_cpu():
    """The same seeds under f32 and bf16 from one warm state: move rates
    in [0, 1], a finite mean |delta log-accept|, the random-walk cells'
    proposals shared (MH's delta is the density's perturbation alone)."""
    out = nn_perf.bf16_delta(iters=3, only="mnist_CNN_mh,cifar_sp_hmc",
                             **SMALL)
    assert set(out) == {"mnist_CNN_mh", "cifar_sp_hmc"}
    for name, cell in out.items():
        assert set(cell) == {"move_rate_f32", "move_rate_bf16",
                             "mean_abs_dlogA", "move_rate_delta"}, name
        assert 0 <= cell["move_rate_f32"] <= 1
        assert 0 <= cell["move_rate_bf16"] <= 1
        assert np.isfinite(cell["mean_abs_dlogA"])
    assert out["mnist_CNN_mh"]["mean_abs_dlogA"] < 0.5


def test_bf16_chain_smoke_on_the_cpu(tmp_path):
    res = nn_perf.bf16_chain(algo="pmp", num_steps=4, chunk=2, n_train=24,
                             n_test=8, pretrain_steps=1, proposal_chunk=4,
                             out_dir=str(tmp_path), device="cpu")
    for d in ("f32", "bf16"):
        assert 0 <= res[d]["move_rate"] <= 1
        assert np.isfinite(res[d]["loss_mean_tail"])
    assert set(res["gaps"]) == {"move_rate", "loss_mean_tail", "train_acc",
                                "test_acc"}
    z = np.load(tmp_path / "bf16_chain_pmp.npz")
    assert z["loss_f32"].shape == z["loss_bf16"].shape == (4,)
    with open(tmp_path / "bf16_chain_pmp.json") as f:
        assert json.load(f)["protocol"]["cell"] == "MNIST_CNN_PMP"
    with pytest.raises(ValueError, match="divisible"):
        nn_perf.bf16_chain(num_steps=5, chunk=2, device="cpu")


def test_run_merges_cells_into_its_json(tmp_path):
    out_dir = str(tmp_path)
    nn_perf.run(mode="table", iters=1, only="mnist_FC_mh", out_dir=out_dir,
                **SMALL)
    out = nn_perf.run(mode="table", iters=1, only=("mnist_LSTM_mh",),
                      out_dir=out_dir, **SMALL)
    with open(os.path.join(out_dir, "nn_perf.json")) as f:
        saved = json.load(f)
    assert saved == json.loads(json.dumps(out))
    assert set(saved["us_per_superstep"]) == {"mnist_FC_mh", "mnist_LSTM_mh"}
    assert saved["backend"] == "cpu" and saved["N"] == 7


def test_footprint_needs_a_card(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA card"):
        nn_perf.footprint(P=2, n_train=16, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        nn_perf.run(mode="both", out_dir=str(tmp_path), device="cpu")


def test_cli_lists_and_runs_nn_perf(tmp_path, capsys):
    assert cli.main(["list"]) == 0
    assert "nn_perf" in capsys.readouterr().out.split()
    assert cli.main(["run", "nn_perf", "--mode", "table", "--iters", "1",
                     "--only", "mnist_FC_mp", "--n_mnist", "16",
                     "--out_dir", str(tmp_path), "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["us_per_superstep"]["mnist_FC_mp"] > 0


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def _work(x):
    for _ in range(20):
        x = torch.tanh(x @ x) * 0.5
    return x


def test_trace_and_device_time(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)):
        _work(x)
    files = [f for f in os.listdir(tmp_path) if f.startswith("trace_")]
    assert len(files) == 1
    ops = profiling.device_time_us(str(tmp_path), category="cpu_op")
    assert ops.get("aten::mm", 0) > 0 and ops.get("aten::tanh", 0) > 0
    assert all(v >= 0 for v in ops.values())
    only_mm = profiling.device_time_us(str(tmp_path), prefix="aten::mm",
                                       category="cpu_op")
    assert set(only_mm) == {"aten::mm"}
    # a trace without a card has no kernels, and the default reading is
    # the card's kernels only: it never falls back to the host's ops
    assert profiling.device_time_us(str(tmp_path)) == {}
    time.sleep(0.01)
    with profiling.trace(str(tmp_path)):
        torch.ones(3).sum()
    newest = profiling.device_time_us(str(tmp_path), category="cpu_op")
    assert "aten::mm" not in newest  # the newest trace is read


def test_device_time_without_a_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.device_time_us(str(tmp_path))


def test_superstep_timer_on_the_cpu():
    calls = []

    def run(x):
        calls.append(1)
        return _work(x)

    us = profiling.superstep_timer(run, torch.randn(32, 32), iters=20)
    assert us > 0 and len(calls) == 2  # the warm-up and the timed call
    us = profiling.superstep_timer(run, torch.randn(32, 32), iters=20,
                                   warmup=False)
    assert us > 0 and len(calls) == 3


# ---------------------------------------------------------------------------
# transport and the CLI's doctor
# ---------------------------------------------------------------------------


def test_probe_healthy_cpu(tmp_path):
    r = transport.probe_device(timeout_s=120, cwd=str(tmp_path),
                               device="cpu")
    assert r["ok"], r
    assert r["backend"] == "cpu" and r["device_kind"] == "cpu"
    assert r["torch"] == torch.__version__ and r["probe_s"] < 120


def test_probe_without_a_card_fails_and_never_probes_the_cpu():
    r = transport.probe_device(timeout_s=120)
    if torch.cuda.is_available():
        assert r["ok"] and r["backend"] == "cuda"
    else:
        assert not r["ok"] and "no CUDA device" in r["error"]
        assert "backend" not in r


def test_probe_times_out_bounded(monkeypatch):
    # a wedge: the probe never answers, and a grandchild holds the output
    # stream (the case that blocks a pipe-draining implementation forever
    # after the kill)
    monkeypatch.setattr(
        transport, "_PROBE_CODE",
        "import subprocess, sys, time\n"
        "subprocess.Popen([sys.executable, '-c', "
        "'import time; time.sleep(60)'])\n"
        "time.sleep(60)\n",
    )
    t0 = time.time()
    r = transport.probe_device(timeout_s=2, device="cpu")
    assert not r["ok"] and "did not answer" in r["error"]
    assert time.time() - t0 < 30  # bounded despite the grandchild


def test_probe_reports_nonzero_exit(monkeypatch):
    monkeypatch.setattr(
        transport, "_PROBE_CODE",
        "import sys\n"
        "sys.stderr.write('RuntimeError: CUDA driver initialization "
        "failed')\n"
        "sys.exit(1)\n",
    )
    r = transport.probe_device(timeout_s=30, device="cpu")
    assert not r["ok"] and "initialization failed" in r["error"]


def test_probe_reports_unparseable_output(monkeypatch):
    monkeypatch.setattr(transport, "_PROBE_CODE", "print('hello')\n")
    r = transport.probe_device(timeout_s=30, device="cpu")
    assert not r["ok"] and "unparseable" in r["error"]


def test_doctor_report_shape(monkeypatch, tmp_path):
    monkeypatch.setenv("PMPX_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    (tmp_path / "mnist.npz").write_bytes(b"x")  # presence check only
    rep = transport.doctor_report(probe_timeout_s=120, device="cpu")
    assert rep["device"]["ok"]
    assert rep["cuda_visible_devices"] == "0"
    assert rep["datasets"]["mnist_npz"] is True
    assert rep["datasets"]["cifar10_batches"] is False
    assert isinstance(rep["native_runtime"], bool)


def test_cli_doctor_exit_codes(monkeypatch, capsys):
    rc = cli.main(["doctor", "--device", "cpu", "--probe-timeout", "120"])
    rep = json.loads(capsys.readouterr().out)
    assert rc == 0 and rep["device"]["ok"]
    rc = cli.main(["doctor"])
    rep = json.loads(capsys.readouterr().out)
    assert rc == (0 if torch.cuda.is_available() else 1)
    assert rep["device"]["ok"] is torch.cuda.is_available()
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return {"ok": False, "error": "x", "probe_s": 0.0}

    monkeypatch.setattr(transport, "probe_device", fake)
    assert cli.main(["doctor", "--device", "cpu", "--probe-timeout",
                     "7"]) == 1
    assert seen == {"timeout_s": 7.0, "device": "cpu"}
