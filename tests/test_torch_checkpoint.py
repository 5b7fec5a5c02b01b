"""Checkpoint/resume of pmpx_torch (port of pmpx/checkpoint.py): chunked
and resumed chains bit-equal to one run_chain of the same seed, the crash
contract of the checkpoint file, the backend guards against pmpx's
checkpoints and sidecars, the SIGKILL resilience experiment, and the
checkpointed experiments through the CLI."""

import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pmpx import checkpoint as jckpt  # noqa: E402
from pmpx_torch import checkpoint as ck  # noqa: E402
from pmpx_torch import cli  # noqa: E402
from pmpx_torch.config import SamplerSpec  # noqa: E402
from pmpx_torch.metrics.recorder import load_trace  # noqa: E402
from pmpx_torch.models import BayesMLP  # noqa: E402
from pmpx_torch.samplers.base import run_chain  # noqa: E402
from pmpx_torch.targets.linreg import (  # noqa: E402
    BayesLinReg, make_synthetic_linreg,
)
from pmpx_torch.targets.nn import NNPosterior  # noqa: E402


def _linreg(n=2000):
    g = torch.Generator().manual_seed(0)
    x, y = make_synthetic_linreg(g, n)
    return BayesLinReg(x, y, temper=1 / 2000, method="sweep", device="cpu")


def _bnn():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((64, 28, 28)).astype(np.float32)
    Y = rng.integers(0, 10, 64)
    return NNPosterior(BayesMLP(hidden=16), X, Y, stochastic=True,
                       device="cpu")


def _cases():
    lin = _linreg()
    return {
        "pmp": (SamplerSpec(algo="pmp", N=1, depth=3, step_size=0.02,
                            selection="all_uniform").build(lin),
                torch.tensor([0.0, 0.0, 1.0]), lambda th, o: th),
        "pmp_hmc": (SamplerSpec(algo="pmp_hmc", N=1, depth=2,
                                step_size=0.002).build(lin),
                    torch.tensor([-1.0, 2.0, 0.5]),
                    lambda th, o: (th, o["log_accept"])),
    }


def _straight(superstep, theta0, steps, collect, seed=3):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        return run_chain(superstep, g, theta0, steps, collect=collect)


def _stack(chunks):
    first = chunks[0]
    if isinstance(first, tuple):
        return tuple(np.concatenate([c[i] for c in chunks])
                     for i in range(len(first)))
    return np.concatenate(chunks)


@pytest.mark.parametrize("sampler", ["pmp", "pmp_hmc"])
@pytest.mark.parametrize("chunk", [1, 5, 7, 30])
def test_chunked_resume_chain_is_one_run_chain(tmp_path, sampler, chunk):
    """Chunk sizes that divide the 30 steps and ones that do not: the
    same final state and records, bit for bit."""
    sup, theta0, collect = _cases()[sampler]
    thF, recs = _straight(sup, theta0, 30, collect)
    path = str(tmp_path / "c.ckpt")
    ck.save_checkpoint(path, theta0, torch.Generator().manual_seed(3), 0)
    with torch.no_grad():
        th, chunks = ck.resume_chain(sup, path, 30, collect=collect,
                                     checkpoint_every=chunk)
    assert len(chunks) == -(-30 // chunk)
    assert torch.equal(th, thF)
    want = (tuple(r.numpy() for r in recs) if isinstance(recs, tuple)
            else recs.numpy())
    got = _stack(chunks)
    for w, g in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        np.testing.assert_array_equal(g, w)
    theta, gen, step, _ = ck.load_checkpoint(path)
    assert step == 30 and torch.equal(theta, thF)


def test_stochastic_target_resumes_bit_equal(tmp_path):
    """A needs_rng posterior draws its noise from the chain's generator:
    restoring the generator's state restores those draws too."""
    sup = SamplerSpec(algo="sp_hmc", step_size=0.05,
                      mom_scale=0.01).build(_bnn())
    theta0 = _bnn().init_theta()
    collect = lambda th, o: o["log_accept"]  # noqa: E731
    _, recs = _straight(sup, theta0, 9, collect)
    path = str(tmp_path / "b.ckpt")
    ck.save_checkpoint(path, theta0, torch.Generator().manual_seed(3), 0)
    acc = ck.TraceAccumulator(str(tmp_path), "b", ("la",))
    with torch.no_grad():
        ck.resume_chain(sup, path, 4, collect=collect, checkpoint_every=3,
                        on_chunk=acc)  # an interrupted run: steps 0-3
        ck.resume_chain(sup, path, 9, collect=collect, checkpoint_every=3,
                        on_chunk=acc)  # the relaunch
    np.testing.assert_array_equal(acc.load(), recs.numpy())


def test_resume_after_interruption_is_bit_equal(tmp_path):
    """An interrupted run (its last chunk re-run from the checkpoint, as a
    kill between the records and the checkpoint leaves it) ends with the
    uninterrupted run's trace."""
    sup, theta0, collect = _cases()["pmp"]
    _, recs = _straight(sup, theta0, 40, collect)
    path = str(tmp_path / "c.ckpt")
    ck.save_checkpoint(path, theta0, torch.Generator().manual_seed(3), 0)
    acc = ck.TraceAccumulator(str(tmp_path), "c", ("theta",))
    with torch.no_grad():
        ck.resume_chain(sup, path, 20, collect=collect, checkpoint_every=10,
                        on_chunk=acc)
        # records of steps 20-29 persisted, the checkpoint not yet saved
        keep = ck.load_checkpoint(path)
        ck.resume_chain(sup, path, 30, collect=collect, checkpoint_every=10,
                        on_chunk=acc)
        ck.save_checkpoint(path, keep[0], keep[1], keep[2])
        _, chunks = ck.resume_chain(sup, path, 40, collect=collect,
                                    checkpoint_every=10, on_chunk=acc)
    assert len(chunks) == 2  # 20-29 again, then 30-39
    np.testing.assert_array_equal(acc.load(), recs.numpy())
    assert len(acc.chunk_walls) == 5
    assert acc.steady_s_per_step(10) is not None


def test_checkpoint_roundtrip(tmp_path):
    g = torch.Generator().manual_seed(9)
    torch.rand(17, generator=g)
    theta = torch.randn(5)
    path = ck.save_checkpoint(str(tmp_path / "sub" / "x.ckpt"), theta, g, 12,
                              extra={"count": np.arange(3)})
    t2, g2, step, extra = ck.load_checkpoint(path)
    assert step == 12 and torch.equal(t2, theta)
    assert torch.equal(g2.get_state(), g.get_state())
    assert torch.equal(torch.rand(4, generator=g2), torch.rand(4, generator=g))
    np.testing.assert_array_equal(extra["count"].numpy(), np.arange(3))
    with np.load(path) as z:
        assert str(z["backend"]) == "torch" and str(z["gen_device"]) == "cpu"
    with pytest.raises(FileNotFoundError):
        ck.resume_chain(None, str(tmp_path / "none.ckpt"), 3)


def test_load_checkpoint_refuses_a_pmpx_checkpoint(tmp_path):
    path = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(path, np.zeros(3, np.float32),
                          jax.random.key(0), 5)
    with pytest.raises(ValueError, match="pmpx \\(JAX\\) checkpoint"):
        ck.load_checkpoint(path)
    with pytest.raises(ValueError, match="pmpx \\(JAX\\) checkpoint"):
        ck.resume_chain(None, path, 10)


def test_torn_tmp_never_replaces_the_checkpoint(tmp_path, monkeypatch):
    path = str(tmp_path / "c.ckpt")
    g = torch.Generator().manual_seed(1)
    ck.save_checkpoint(path, torch.ones(3), g, 10)
    real = np.savez

    def torn(f, **arrays):
        f.write(b"PK\x03\x04 half an archive")
        raise KeyboardInterrupt  # killed mid-write

    monkeypatch.setattr(ck.np, "savez", torn)
    with pytest.raises(KeyboardInterrupt):
        ck.save_checkpoint(path, torch.zeros(3), g, 20)
    assert os.path.exists(path + ".tmp")
    theta, _, step, _ = ck.load_checkpoint(path)
    assert step == 10 and torch.equal(theta, torch.ones(3))
    monkeypatch.setattr(ck.np, "savez", real)
    ck.save_checkpoint(path, torch.zeros(3), g, 20)
    assert ck.load_checkpoint(path)[2] == 20
    assert not os.path.exists(path + ".tmp")


def _name(s):
    return f"PMP_alpha_0.0001_sample_number_{s}FC_N_7"


def _fake_run(out_dir, steps, protocol, backend="torch"):
    stem = _name(steps)
    if backend == "torch":
        ck.save_checkpoint(os.path.join(out_dir, stem + ".ckpt"),
                           torch.zeros(2), torch.Generator(), steps)
        if protocol is not None:
            ck.write_protocol_sidecar(out_dir, stem, protocol)
    else:
        jckpt.save_checkpoint(os.path.join(out_dir, stem + ".ckpt"),
                              np.zeros(2, np.float32), jax.random.key(0),
                              steps)
        if protocol is not None:
            jckpt.write_protocol_sidecar(out_dir, stem, protocol)
    np.save(os.path.join(out_dir, stem + ".loss.npy"), np.arange(steps))


def test_adopt_prefix_run_refuses_another_backend(tmp_path, capsys):
    d = str(tmp_path)
    proto = {"temper": 10.0, "seed": 0}
    # a pmpx run, longer than the torch one: never adopted
    _fake_run(d, 300, proto, backend="jax")
    # a torch checkpoint beside a sidecar that pmpx wrote (no backend)
    _fake_run(d, 250, None)
    jckpt.write_protocol_sidecar(d, _name(250), proto)
    # another posterior
    _fake_run(d, 200, {"temper": 1.0, "seed": 0})
    _fake_run(d, 100, proto)
    with open(os.path.join(d, _name(100) + ".protocol.json")) as f:
        assert json.load(f)["backend"] == "torch"
    assert ck.adopt_prefix_run(d, _name, 400, keys=("loss",),
                               protocol=proto) == 100
    np.testing.assert_array_equal(
        np.load(os.path.join(d, _name(400) + ".loss.npy")), np.arange(100))
    assert ck.load_checkpoint(os.path.join(d, _name(400) + ".ckpt"))[2] == 100
    # the new stem exists now: nothing more to adopt
    assert ck.adopt_prefix_run(d, _name, 400, protocol=proto) is None
    # a torch run with no sidecar is adopted, loudly
    e = str(tmp_path / "e")
    os.makedirs(e)
    _fake_run(e, 50, None)
    assert ck.adopt_prefix_run(e, _name, 60, protocol=proto) == 50
    assert "WARNING" in capsys.readouterr().out


def test_trace_accumulator_guards_its_sync(tmp_path):
    acc = ck.TraceAccumulator(str(tmp_path), "t", ("a", "b"))
    acc(0, (np.arange(4), np.ones((4, 2))))
    acc(4, (np.arange(4, 8), np.ones((4, 2))))
    acc(4, (np.arange(4, 8), np.ones((4, 2))))  # a re-run chunk
    np.testing.assert_array_equal(acc.load("a"), np.arange(8))
    with pytest.raises(RuntimeError, match="out of sync"):
        acc(12, (np.arange(2), np.ones((2, 2))))
    with pytest.raises(ValueError):
        acc(8, (np.arange(2),))
    assert ck.TraceAccumulator(str(tmp_path), "t", ("a",),
                               fresh=False).load().shape == (8,)
    assert not os.path.exists(ck.TraceAccumulator(
        str(tmp_path), "t", ("a",)).paths["a"])  # fresh removes it


# ---------------------------------------------------------------------------
# the resilience experiment: real processes, SIGKILL, files
# ---------------------------------------------------------------------------


def _one_thread(monkeypatch):
    """The child processes' chains are sequential: one intra-op thread
    each keeps them from contending with the other test workers."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_sigkill_resume_bitwise_identical(tmp_path, monkeypatch):
    from pmpx_torch.experiments import resilience

    _one_thread(monkeypatch)

    s = resilience.run(num_steps=900, checkpoint_every=150, kills=1,
                       n_data=4096, depth=4, throttle_ms=500,
                       out_dir=str(tmp_path), device="cpu")
    assert s["bitwise_identical"]
    assert s["rows"] == 900
    assert s["kills"] >= 1 and s["launches"] >= 2
    with open(tmp_path / "summary.json") as f:
        assert json.load(f)["bitwise_identical"]


def test_exit_mode_resume_bitwise_identical(tmp_path, monkeypatch):
    from pmpx_torch.experiments import resilience

    _one_thread(monkeypatch)

    s = resilience.run(num_steps=300, checkpoint_every=100, kills=2,
                       n_data=1024, depth=3, kill_mode="exit",
                       out_dir=str(tmp_path), device="cpu")
    assert s["bitwise_identical"] and s["rows"] == 300
    assert [k["clean_exit_at_step"] for k in s["kill_log"]] == [100, 200]
    with pytest.raises(ValueError):
        resilience.run(kill_mode="nope", out_dir=str(tmp_path),
                       device="cpu")


# ---------------------------------------------------------------------------
# the checkpointed experiments, end to end through the CLI
# ---------------------------------------------------------------------------


def _cli(capsys, *args):
    assert cli.main(["run", *args, "--device", "cpu"]) == 0
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("exp,args,name,key", [
    ("cifar_hmc", ["--algo", "pmp_hmc", "--n_train", "48", "--n_test",
                   "16", "--pretrain_steps", "2"], "cifar_pmp_hmc",
     "test_acc"),
    ("cifar_hmc", ["--algo", "mp_hmc", "--N", "3", "--n_train", "32",
                   "--n_test", "16", "--pretrain_steps", "0"],
     "cifar_mp_hmc", "loss"),
    ("bnn", ["--n", "2", "--hidden", "16", "--n_train", "48", "--n_test",
             "16"], "bnn_pmphmc_N3", "trajectory10"),
])
def test_experiment_chunks_resume_like_one_loop(tmp_path, capsys, exp, args,
                                                name, key):
    """5 steps in one loop; the same run in chunks of 2 stopped at 3 steps
    and resumed to 5: the same saved trace, bit for bit."""
    one = str(tmp_path / "one")
    _cli(capsys, exp, *args, "--num_steps", "5", "--out_dir", one)
    cut = str(tmp_path / "cut")
    _cli(capsys, exp, *args, "--num_steps", "3", "--chunk_steps", "2",
         "--out_dir", cut)
    res = _cli(capsys, exp, *args, "--num_steps", "5", "--chunk_steps", "2",
               "--resume", "true", "--out_dir", cut)
    assert np.isfinite(res["loss_last"])
    want = load_trace(os.path.join(one, name + ".npz"))
    got = load_trace(os.path.join(cut, name + ".npz"))
    assert got[key].shape[0] == 5
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_mnist_chunk_steps_adopt_and_resume(tmp_path, capsys):
    """mnist's checkpointed chunks: a 4-step run extended to 6 by
    --resume adopts the shorter run's checkpoint (its stem embeds the step
    count) and ends with the one-loop chain's losses."""
    common = ["mnist", "--model", "FC", "--algo", "pmp", "--n_train", "64",
              "--n_test", "16", "--pretrain_steps", "1"]
    one = str(tmp_path / "one")
    _cli(capsys, *common, "--num_steps", "6", "--out_dir", one)
    cut = str(tmp_path / "cut")
    res = _cli(capsys, *common, "--num_steps", "4", "--chunk_steps", "2",
               "--out_dir", cut)
    assert res["steady_ms_per_superstep"] > 0  # the second chunk's
    assert cli.main(["run", *common, "--num_steps", "6", "--chunk_steps",
                     "2", "--resume", "true", "--out_dir", cut,
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "adopted 4-step prefix run" in out
    res = json.loads(out[out.index("{"):])
    assert np.isfinite(res["loss_last"])
    stem = "PMP_alpha_0.0001_sample_number_6FC_N_7"
    want = load_trace(os.path.join(one, stem + ".npz"))["loss"]
    got = load_trace(os.path.join(cut, stem + ".npz"))["loss"]
    np.testing.assert_array_equal(got, want)
    with open(os.path.join(cut, stem + ".protocol.json")) as f:
        assert json.load(f)["backend"] == "torch"


def test_cifar_packed_layout_resumes_like_one_loop(tmp_path, capsys):
    """cifar_hmc with layout="packed" (PackedLeNet): 4 SP-HMC steps in one
    loop, and the same run in chunks of 2 stopped at 2 steps and resumed
    to 4, the saved traces bit-equal; an unknown algo still raises."""
    from pmpx_torch.experiments import cifar_hmc

    args = ["cifar_hmc", "--layout", "packed", "--algo", "sp_hmc",
            "--n_train", "24", "--n_test", "8", "--pretrain_steps", "1"]
    one, cut = str(tmp_path / "one"), str(tmp_path / "cut")
    _cli(capsys, *args, "--num_steps", "4", "--out_dir", one)
    _cli(capsys, *args, "--num_steps", "2", "--chunk_steps", "2",
         "--out_dir", cut)
    res = _cli(capsys, *args, "--num_steps", "4", "--chunk_steps", "2",
               "--resume", "true", "--out_dir", cut)
    assert np.isfinite(res["loss_last"])
    want = load_trace(os.path.join(one, "cifar_sp_hmc.npz"))
    got = load_trace(os.path.join(cut, "cifar_sp_hmc.npz"))
    assert got["loss"].shape[0] == 4 and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError):
        cifar_hmc.run(algo="mh", device="cpu")
