"""The port's entry points outside the package, on the CPU: the two
examples (``examples/*_torch.py``), the NN zoo, the paper-protocol queue
and its summaries, and the small-P profile (``scripts/*_torch.py``),
each held to its ``pmpx`` counterpart where the two can run on the same
inputs, with the port's defaults and packaging checked beside them."""

import ast
import fnmatch
import importlib
import importlib.util
import inspect
import json
import os
import pkgutil
import re
import shutil
import subprocess
import sys
import time
import tomllib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent

# the entry points of the repo before the port, each with its port
PORTED = {
    "examples/quickstart.py": "examples/quickstart_torch.py",
    "examples/bayesian_nn.py": "examples/bayesian_nn_torch.py",
    "scripts/run_zoo.py": "scripts/run_zoo_torch.py",
    "scripts/run_paper.py": "scripts/run_paper_torch.py",
    "scripts/summarize_paper.py": "scripts/summarize_paper_torch.py",
    "scripts/profile_smallp.py": "scripts/profile_smallp_torch.py",
}
# ... or without one, and why
TPU_ONLY = {
    "__graft_entry__.py": "a jit compile check and a virtual-mesh dry run "
    "of pmpx; chip_smoke.py is the port's check on the card",
    "scripts/emit_ablation.py": "stages of the Pallas emit pipeline, which "
    "the CUDA chain kernel does not have",
    "scripts/chip_recovery.py": "recovery of a wedged TPU transport",
    "scripts/queue_watchdog.py": "the TPU transport's wedge watchdog "
    "(run_paper_torch.py keeps its stall monitor)",
    "scripts/run_multichain_farm.py": "pmpx's virtual 8-device CPU mesh; "
    "the port's farm table is `pmpx_torch.cli run multichain --mode sweep "
    "--path fused`",
}
# scripts the port added for its own measurements
PORT_SCRIPTS = ("scripts/rss_cluster_fit.py", "scripts/lenet_grad_profile.py")


def _load(rel: str, name: str | None = None):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        name or f"_entry_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def queue():
    return _load("scripts/run_paper_torch.py")


# -- coverage ---------------------------------------------------------------

def test_every_entry_point_is_ported_or_tpu_only():
    found = {str(p.relative_to(ROOT))
             for d in ("examples", "scripts") for p in (ROOT / d).glob("*.py")
             if not p.name.endswith("_torch.py")}
    want = {k for k in (*PORTED, *TPU_ONLY)
            if k.startswith(("examples/", "scripts/"))} | set(PORT_SCRIPTS)
    assert found == want, sorted(found ^ want)
    assert (ROOT / "__graft_entry__.py").exists()
    for old, new in PORTED.items():
        assert (ROOT / old).exists() and (ROOT / new).exists(), (old, new)
    ports = {str(p.relative_to(ROOT))
             for d in ("examples", "scripts")
             for p in (ROOT / d).glob("*_torch.py")}
    assert ports == set(PORTED.values())
    assert all(len(why) > 20 for why in TPU_ONLY.values())


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and re.search(r"-m pmpx\.|^pmpx\.", node.value)):
            names.add(node.value)
    return names


@pytest.mark.parametrize("rel", sorted(PORTED.values()) + list(PORT_SCRIPTS))
def test_port_entry_point_imports_no_jax_and_no_pmpx(rel):
    bad = {n for n in _imports(ROOT / rel)
           if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "pmpx")}
    assert not bad, bad
    assert "pmpx_torch" in {n.split(".")[0] for n in _imports(ROOT / rel)}


# -- the quickstart, statistically against pmpx's ----------------------------

# the banana's marginal sds: x1 ~ N(0, 1), x2 = 2 (x1^2 - 5) + N(0, 1)
BANANA_MEAN, BANANA_SD = np.array([0.0, -8.0]), np.array([1.0, 3.0])

_PMPX_QUICKSTART = (
    "import json, runpy\n"
    "import numpy as np\n"
    "g = runpy.run_path('examples/quickstart.py')\n"
    "s = g['samples']\n"
    "print('RESULT ' + json.dumps({\n"
    "    'shape': list(np.asarray(g['recs']['samples']).shape),\n"
    "    'mean': s.mean(axis=0).tolist(),\n"
    "    'ess': np.asarray(g['ess_per_dim'](g['jnp'].asarray(s))).tolist()}))\n"
)


def test_quickstart_matches_pmpx_statistically():
    """Both chains at the example's own 10,000 supersteps (another PRNG
    stream each): the same record shape, each mean within 4 Monte Carlo
    standard errors (the marginal sd over the root of the chain's ESS)
    of the analytic one, and the two means within 4 of their difference's
    standard errors of each other."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _PMPX_QUICKSTART],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    quick = _load("examples/quickstart_torch.py")
    got = quick.main(device="cpu")
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-2000:]
    ref = json.loads(out.split("RESULT ", 1)[1])
    assert got["records_shape"] == tuple(ref["shape"]) == (10_000, 16, 2)
    assert got["samples"].shape == (128_000, 2)
    se = {}
    for name, mean, ess in (("port", got["mean"], got["ess"]),
                            ("pmpx", ref["mean"], ref["ess"])):
        se[name] = BANANA_SD / np.sqrt(np.asarray(ess))
        z = np.abs(np.asarray(mean) - BANANA_MEAN) / se[name]
        assert (z < 4.0).all(), (name, mean, ess, z)
    diff = np.abs(np.asarray(got["mean"]) - np.asarray(ref["mean"]))
    assert (diff < 4.0 * np.hypot(se["port"], se["pmpx"])).all(), diff
    assert got["msjd"] > 0.1


def test_bayesian_nn_example_learns():
    out = _load("examples/bayesian_nn_torch.py").main(num_steps=20,
                                                      device="cpu")
    assert set(out) == {"loss_first", "loss_last", "test_accuracy"}
    assert np.isfinite(list(out.values())).all()
    assert out["loss_last"] < out["loss_first"]


@pytest.mark.parametrize("rel,call", [
    ("examples/quickstart_torch.py", lambda m: m.main(num_steps=2)),
    ("examples/bayesian_nn_torch.py", lambda m: m.main(num_steps=2)),
    ("scripts/run_zoo_torch.py", lambda m: m.main(cells=())),
    ("scripts/run_paper_torch.py", lambda m: m.main("missing.json")),
    ("scripts/profile_smallp_torch.py", lambda m: m.main(iters=2)),
])
def test_entry_point_raises_without_a_card(rel, call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(_load(rel))


# -- the summaries: the port's JSON equals pmpx's on the same traces ---------

# free text that names each package's own protocol; present in both, not
# compared word for word
PROSE = {"protocol", "note", "question", "mechanism", "frozen_note",
         "ablation_protocol"}


def _same(a, b, path="") -> None:
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (
            path, sorted(set(a) ^ set(b)))
        for k in a:
            if k in PROSE:
                assert isinstance(b[k], str) and b[k], (path, k)
            else:
                _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        assert abs(a - b) <= 1e-6 * max(1.0, abs(a)), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _trace(rng, n, start, end, noise=0.02):
    return (np.linspace(start, end, n) * (1 + noise * rng.standard_normal(n))
            ).astype(np.float32)


def _write(d: Path, stem: str, arrays: dict, meta: dict | None) -> None:
    d.mkdir(parents=True, exist_ok=True)
    for k, v in arrays.items():
        np.save(d / f"{stem}.{k}.npy", v)
    if meta is not None:
        (d / f"{stem}.json").write_text(json.dumps(meta))


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """Synthetic traces under every family's file names: CIFAR SP and
    PMP (MP missing) and the full ablation, BNN SP and PMP, MNIST cells on
    both paths with a superseded prefix, and both ESS summaries."""
    root = tmp_path_factory.mktemp("paper")
    rng = np.random.default_rng(0)
    for algo, ms in (("sp_hmc", 253.0), ("pmp_hmc", 669.5)):
        _write(root / "cifar", f"cifar_{algo}",
               {"loss": _trace(rng, 1500, 2.0, 0.4),
                "train_acc": _trace(rng, 1500, 0.3, 0.95),
                "test_acc": _trace(rng, 1500, 0.3, 0.9)},
               {"N": 7, "steady_ms_per_superstep": ms})
    for i, algo in enumerate(("sp_hmc", "mp_hmc", "pmp_hmc")):
        _write(root / "cifar_ablation", f"cifar_{algo}",
               {"loss": _trace(rng, 600, 2.3, 1.0 + 0.1 * i),
                "train_acc": _trace(rng, 600, 0.2, 0.6 - 0.05 * i),
                "test_acc": _trace(rng, 600, 0.2, 0.55 - 0.04 * i)}, None)
    n = 3000
    t = np.arange(n)
    for stem, rate, ms in (("bnn_sphmc", 800.0, 25.079),
                           ("bnn_pmphmc_N3", 300.0, 33.219)):
        loss = (2.0 * np.exp(-t / rate) + 0.1
                + 0.01 * rng.standard_normal(n)).astype(np.float32)
        _write(root / "bnn_flagship", stem,
               {"loss": loss, "acc": _trace(rng, n, 0.1, 0.97)},
               {"steady_ms_per_superstep": ms})
    for d, stem, steps, model in (
            ("mnist", "PMP_alpha_0.0001_sample_number_500000FC_N_7", 5000,
             "FC"),
            ("mnist", "PMP_alpha_0.0001_sample_number_250000FC_N_7", 2500,
             "FC"),
            ("mnist", "MH_alpha_0.0001_sample_number_250000CNN_N_7", 1200,
             "CNN"),
            ("mnist", "MP_alpha_0.0001_sample_number_1000000LSTM_N_7", 800,
             "LSTM"),
            ("mnist_kernel", "MP_alpha_0.0001_sample_number_1000000LSTM_N_7",
             3000, "LSTM"),
            ("mnist_kernel", "MH_alpha_0.0001_sample_number_1000000LSTM_N_7",
             2000, "LSTM")):
        _write(root / d, stem, {"loss": _trace(rng, steps, 2.0, 0.5)},
               {"model": model, "train_acc": 0.9, "test_acc": 0.88,
                "num_steps": steps, "steady_ms_per_superstep": 12.5})
    (root / "mnist_kernel" /
     "MH_alpha_0.0001_sample_number_1000000LSTM_N_7.protocol.json"
     ).write_text("{}")
    for d, scale in (("ess_scan", 1.0), ("ess_fused", 3.0)):
        summary = {}
        for algo in ("mp", "pmp"):
            for P in (8, 32, 512):
                for m in ("ess_per_s", "msjd_per_s"):
                    summary[f"{algo}_P{P}_all_{m}"] = scale * P * (
                        1.5 if algo == "pmp" else 1.0) * (
                        2.0 if m == "msjd_per_s" else 1.0)
                    summary[f"{algo}_P{P}_{m}"] = scale * P
        (root / d).mkdir()
        (root / d / "summary.json").write_text(json.dumps(summary))
    return root


def _family(mod, family: str, root: Path, out: Path) -> dict:
    """Runs one family of a summarize module over ``root`` and returns
    the JSON it wrote (``out`` holds the copy of ``root`` it wrote in)."""
    shutil.copytree(root, out)
    if family == "cifar":
        # pmpx's reads its ablation from artifacts/cifar_ablation under the
        # working directory; the port's from its argument
        abl = ({"abl_dir": str(out / "cifar_ablation")}
               if "abl_dir" in inspect.signature(mod.cifar).parameters
               else {})
        mod.cifar(str(out / "cifar"), **abl)
        return json.loads((out / "cifar" / "summary.json").read_text())
    if family == "bnn":
        mod.bnn(str(out / "bnn_flagship"))
        return json.loads(
            (out / "bnn_flagship" / "bnn_flagship.json").read_text())
    if family == "mnist":
        mod.mnist(str(out / "mnist"), str(out / "mnist_kernel"))
        return json.loads((out / "mnist" / "summary.json").read_text())
    mod.ess(str(out / "ess_scan"), str(out / "ess_fused"),
            str(out / "ess_paths"))
    return json.loads((out / "ess_paths" / "ess_paths.json").read_text())


@pytest.fixture(scope="module")
def summarizers():
    return (_load("scripts/summarize_paper.py", "_pmpx_summarize_paper"),
            _load("scripts/summarize_paper_torch.py"))


@pytest.mark.parametrize("family", ["cifar", "bnn", "mnist", "ess"])
def test_summaries_equal_pmpx(summarizers, traces, tmp_path, monkeypatch,
                              family):
    ref_mod, port_mod = summarizers
    # the ablation as pmpx's default directory would hold it
    monkeypatch.chdir(tmp_path)
    (tmp_path / "artifacts").mkdir()
    shutil.copytree(traces / "cifar_ablation",
                    tmp_path / "artifacts" / "cifar_ablation")
    want = _family(ref_mod, family, traces, tmp_path / "pmpx")
    got = _family(port_mod, family, traces, tmp_path / "port")
    if family == "cifar":
        assert got["ordering_reconciliation"]["ablation_finals"]
    _same(want, got)
    if family == "bnn":
        assert np.isfinite(got["speedup_fit_iterations"])
        assert got["speedup_fit_iterations"] > 1.5  # PMP's faster decay
    if family == "mnist":
        assert got["current_cells"]["PMP_FC"].endswith("500000FC_N_7")
        assert got["current_cells"]["MP_LSTM_kernel"].endswith("@kernel")
        assert got["MP_alpha_0.0001_sample_number_1000000LSTM_N_7"]["final"]
    if family == "cifar":
        assert got["mp_hmc"] == {"note": "trace not present (not run this "
                                         "round)"}


def test_summaries_skip_missing_families_with_a_note(summarizers, tmp_path,
                                                    capsys):
    ref_mod, port_mod = summarizers
    for mod in (ref_mod, port_mod):
        empty = tmp_path / mod.__name__
        (empty / "bnn").mkdir(parents=True)
        assert mod.ess(str(empty / "s"), str(empty / "f"),
                       str(empty / "o")) is None
        assert "missing; skipped" in capsys.readouterr().out
        mod.bnn(str(empty / "bnn"))
        res = json.loads((empty / "bnn" / "bnn_flagship.json").read_text())
        assert res["sp_hmc"] == res["pmp_hmc"] == {"note": "trace not present"}
    # the port's whole summary over an empty root raises nothing
    out = port_mod.main("all", str(tmp_path / "nothing"))
    assert out["ess"] is None and out["cifar"]["sp_hmc"]["note"]
    assert set(out) == {"cifar", "bnn", "bnn_hard", "mnist", "ess"}


# -- the queue ----------------------------------------------------------------

def _record_subprocesses(monkeypatch) -> list:
    """Records the command of every subprocess started from now on."""
    started = []
    for name in ("Popen", "run", "call", "check_call", "check_output"):
        def wrapper(cmd, *a, _real=getattr(subprocess, name), **k):
            started.append([cmd] if isinstance(cmd, str) else list(cmd))
            return _real(cmd, *a, **k)

        monkeypatch.setattr(subprocess, name, wrapper)
    return started


FLAKY = """import os, sys
p = sys.argv[1]
n = int(open(p).read()) if os.path.exists(p) else 0
open(p, "w").write(str(n + 1))
sys.exit(0 if n >= 1 else 3)
"""


@pytest.fixture
def fast_queue(queue, tmp_path, monkeypatch):
    """The queue with its state in ``tmp_path``, short waits, a device
    that answers, and a record of every subprocess it starts."""
    monkeypatch.setattr(queue, "STATE_DIR", str(tmp_path / "state"))
    monkeypatch.setattr(queue, "COOLDOWN_S", 0)
    monkeypatch.setattr(queue, "MONITOR_POLL_S", 0.05)
    monkeypatch.setattr(queue, "device_answers", lambda *a, **k: True)
    started = _record_subprocesses(monkeypatch)
    queue.started = started
    return queue


def _queue_file(tmp_path, stages) -> str:
    p = tmp_path / "q.json"
    p.write_text(json.dumps({"stages": stages}))
    return str(p)


def test_queue_retries_a_failed_stage_then_marks_it_done(fast_queue,
                                                         tmp_path):
    (tmp_path / "flaky.py").write_text(FLAKY)
    q = _queue_file(tmp_path, [{"name": "flaky", "cmd": [
        str(tmp_path / "flaky.py"), str(tmp_path / "count")]}])
    assert fast_queue.main(q, device="cpu") == 0
    done = json.loads((tmp_path / "state" / "flaky.done").read_text())
    assert done["attempts"] == 2 and len(fast_queue.started) == 2
    assert not (tmp_path / "state" / "flaky.failed").exists()
    log = (tmp_path / "state" / "flaky.log").read_text()
    assert log.count("=== attempt") == 2


def test_queue_marks_a_stage_failed_after_max_attempts(fast_queue,
                                                       tmp_path):
    (tmp_path / "fail.py").write_text("import sys; sys.exit(2)\n")
    (tmp_path / "ok.py").write_text("print('ok')\n")
    q = _queue_file(tmp_path, [
        {"name": "bad", "cmd": [str(tmp_path / "fail.py")]},
        {"name": "skipped", "skip": True, "cmd": [str(tmp_path / "x.py")]},
        {"name": "good", "cmd": [str(tmp_path / "ok.py")]}])
    assert fast_queue.main(q, device="cpu") == 1
    state = tmp_path / "state"
    assert json.loads((state / "bad.failed").read_text())["argv"] == [
        str(tmp_path / "fail.py")]
    assert not (state / "bad.done").exists() and (state / "good.done").exists()
    assert not (state / "skipped.done").exists()
    assert len(fast_queue.started) == fast_queue.MAX_ATTEMPTS + 1


def test_queue_stall_monitor_terminates_a_silent_stage(fast_queue, tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(fast_queue, "STALL_S", 0.5)
    monkeypatch.setattr(fast_queue, "MAX_ATTEMPTS", 2)
    (tmp_path / "hang.py").write_text("import time; time.sleep(120)\n")
    q = _queue_file(tmp_path, [{"name": "hang", "cmd": [
        str(tmp_path / "hang.py")]}])
    t0 = time.time()
    assert fast_queue.main(q, device="cpu") == 1
    assert time.time() - t0 < 30
    log = (tmp_path / "state" / "hang.log").read_text()
    assert "=== attempt 2" in log
    assert (tmp_path / "state" / "hang.failed").exists()


def test_queue_watches_the_stage_out_dir(queue, tmp_path):
    assert queue._out_dir(["mnist", "--out-dir", "results/x"]) == str(
        ROOT / "results" / "x")
    assert queue._out_dir(["mnist", "--out_dir", str(tmp_path)]) == str(
        tmp_path)
    assert queue._out_dir(["mnist"]) is None
    assert queue.stage_command({"argv": ["mnist"]}, "cpu")[-2:] == [
        "--device", "cpu"]
    assert queue.stage_command({"argv": ["mnist", "--device", "cuda"]},
                               "cpu")[-2:] == ["--device", "cuda"]
    assert queue.stage_command({"cmd": ["s.py", "all"]})[1:] == ["s.py",
                                                                 "all"]


def test_queue_runs_the_cli_and_a_rerun_launches_nothing(queue, tmp_path,
                                                         monkeypatch):
    """An argv stage through ``pmpx_torch.cli run`` at a tiny size on the
    CPU, after the real bounded probe of the CPU; then the same queue
    again, which starts nothing; and no git anywhere."""
    monkeypatch.setattr(queue, "STATE_DIR", str(tmp_path / "state"))
    monkeypatch.setattr(queue, "MONITOR_POLL_S", 0.05)
    started = _record_subprocesses(monkeypatch)
    out = tmp_path / "mnist"
    q = _queue_file(tmp_path, [{"name": "mnist_fc", "argv": [
        "mnist", "--model", "FC", "--algo", "pmp", "--n-train", "64",
        "--n-test", "16", "--num-steps", "4", "--chunk-steps", "2",
        "--pretrain-steps", "2", "--out-dir", str(out)]}])
    assert queue.main(q, device="cpu") == 0
    cli = [c for c in started if "pmpx_torch.cli" in c]
    assert len(cli) == 1 and cli[0][-2:] == ["--device", "cpu"]
    assert any("-c" in c for c in started)  # the probe
    stem = "PMP_alpha_0.0001_sample_number_4FC_N_7"
    assert np.load(out / f"{stem}.loss.npy").shape == (4,)
    assert json.loads((out / f"{stem}.json").read_text())["num_steps"] == 4
    n = len(started)
    assert queue.main(q, device="cpu") == 0
    assert len(started) == n  # every stage .done: no stage, no probe
    assert not any(c and Path(c[0]).name == "git" for c in started)
    assert "git" not in {n.id for n in ast.walk(ast.parse(
        (ROOT / "scripts/run_paper_torch.py").read_text()))
        if isinstance(n, ast.Name)}
    assert not re.search(r"['\"]git['\"]",
                         (ROOT / "scripts/run_paper_torch.py").read_text())


def test_paper_queue_is_the_uncut_protocol():
    """Every argv stage names an experiment of the port and only
    parameters of its run(); every output lies under results/paper/; the
    CIFAR stages start without the reference's cifar.pkl; the summary
    comes last."""
    from pmpx_torch.experiments import EXPERIMENTS

    stages = json.loads(
        (ROOT / "scripts/paper_queue_torch.json").read_text())["stages"]
    names = [s["name"] for s in stages]
    assert len(set(names)) == len(names)
    for s in stages[:-1]:
        argv = s["argv"]
        assert argv[0] in EXPERIMENTS
        params = inspect.signature(importlib.import_module(
            f"pmpx_torch.experiments.{argv[0]}").run).parameters
        keys = [a[2:].replace("-", "_") for a in argv[1::2]]
        assert set(keys) <= set(params), (s["name"], set(keys) - set(params))
        assert argv[argv.index("--out-dir") + 1].startswith("results/paper/")
        assert "--warm-start" not in argv and "--num-steps" not in argv
        assert argv[argv.index("--scale") + 1] == "paper"
    assert stages[-1]["cmd"] == ["scripts/summarize_paper_torch.py", "all",
                                 "results/paper"]
    assert names[:3] == ["cifar_pmp", "cifar_sp", "cifar_mp"]
    assert {n for n in names if n.startswith("mnist_")} == {
        f"mnist_{m}_{a}" for m in ("fc", "cnn", "lstm")
        for a in ("mh", "mp", "pmp")}
    lstm = [s for s in stages if s["name"].startswith("mnist_lstm")]
    assert all("--lstm-kernel" in s["argv"] for s in lstm)


# -- the zoo and the profile --------------------------------------------------

def test_zoo_rows_have_pmpx_keys(tmp_path):
    zoo = _load("scripts/run_zoo_torch.py")
    assert len(zoo.CELLS) == 12
    assert {kw["num_steps"] for f, kw in zoo.CELLS if f == "mnist"} == {2000}
    cut = [(f, dict(kw, num_steps=2, n_train=32, n_test=16, pretrain_steps=1))
           for f, kw in zoo.CELLS]
    rows = zoo.main(cut, str(tmp_path), device="cpu")
    ref_m = json.loads((ROOT / "artifacts/mnist_zoo/summary.json").read_text())
    ref_c = json.loads((ROOT / "artifacts/cifar_zoo/summary.json").read_text())
    got_m = json.loads((tmp_path / "mnist_zoo/summary.json").read_text())
    got_c = json.loads((tmp_path / "cifar_zoo/summary.json").read_text())
    assert [set(r) for r in got_m] == [set(ref_m[0])] * 9
    assert set(got_c) == set(ref_c)
    assert [set(r) for r in got_c["cells"]] == [set(ref_c["cells"][0])] * 3
    assert [(r["model"], r["algo"]) for r in got_m] == [
        (m, a) for m in ("FC", "CNN", "LSTM") for a in ("mh", "mp", "pmp")]
    assert rows["cifar"] == got_c["cells"]


def test_profile_smallp_prints_wall_and_table(capsys):
    prof = _load("scripts/profile_smallp_torch.py")
    out = prof.main(P=4, n_data=500, iters=20, device="cpu")
    text = capsys.readouterr().out
    assert re.search(r"^wall us/iter: \d+\.\d\d$", text, re.M)
    assert re.search(r"^host-op total us/iter: ", text, re.M)
    assert len(re.findall(r"^ +\d+\.\d{3} us/iter  \S", text, re.M)) == len(
        out["top"]) > 3
    assert out["launches"] == {}  # the plain versions count nothing
    assert out["wall_us_per_iter"] > 0 and out["iters"] == 20


# -- defaults and packaging -----------------------------------------------------

def _path_defaults(obj):
    try:
        params = inspect.signature(obj).parameters.values()
    except (TypeError, ValueError):
        return
    for p in params:
        if (p.name in ("out_dir", "out_root", "log_dir", "abl_dir",
                       "kernel_dir", "scan_dir", "fused_dir")
                and isinstance(p.default, str)):
            yield p.name, p.default


def test_no_default_output_lies_under_artifacts():
    """artifacts/ holds pmpx's committed results: no function of the port
    and no port entry point writes there by default."""
    import pmpx_torch

    seen = {}
    mods = [importlib.import_module(m.name) for m in pkgutil.walk_packages(
        pmpx_torch.__path__, "pmpx_torch.")]
    mods += [_load(rel) for rel in sorted(PORTED.values())]
    for mod in mods:
        for name, obj in vars(mod).items():
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            fns = [obj] + ([v for v in vars(obj).values() if callable(v)]
                           if inspect.isclass(obj) else [])
            for fn in fns:
                for pname, default in _path_defaults(fn):
                    seen[f"{mod.__name__}.{name}:{pname}"] = default
        for const in ("STATE_DIR", "ROOT"):
            if isinstance(getattr(mod, const, None), str):
                seen[f"{mod.__name__}.{const}"] = getattr(mod, const)
    assert seen["pmpx_torch.experiments.nn_perf.bf16_chain:out_dir"] == (
        "results/bf16_fidelity")
    assert len(seen) > 20
    bad = {k: v for k, v in seen.items()
           if Path(os.path.relpath(ROOT / v, ROOT)).parts[0] == "artifacts"}
    assert not bad, bad


def test_pyproject_ships_every_source_and_the_console_script():
    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())
    data = cfg["tool"]["setuptools"]["package-data"]
    sources = [p for ext in ("*.cu", "*.cuh", "*.cpp")
               for p in (ROOT / "pmpx_torch").rglob(ext)
               if "_build" not in p.parts]
    assert any(p.name == "pmpx_rt.cpp" for p in sources)
    for src in sources:
        ok = False
        for pkg, pats in data.items():
            pdir = ROOT / pkg.replace(".", "/")
            if pdir in src.parents:
                rel = str(src.relative_to(pdir))
                ok |= any(fnmatch.fnmatch(rel, pat) for pat in pats)
        assert ok, src
    scripts = cfg["project"]["scripts"]
    assert scripts["pmpx"] == "pmpx.cli:main"
    assert scripts["pmpx-torch"] == "pmpx_torch.cli:main"
    mod, fn = scripts["pmpx-torch"].split(":")
    assert callable(getattr(importlib.import_module(mod), fn))
    assert data["pmpx.runtime"] == ["*.cpp", "Makefile"]
