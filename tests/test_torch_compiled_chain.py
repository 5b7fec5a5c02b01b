"""The compiled chain (``pmpx_torch.samplers.base.run_chain``) on the CPU.

On a card ``run_chain`` replays a captured CUDA graph of ``unroll``
supersteps.  Here the same chain (``CompiledChain``) runs with
``capture=False``: its static state, its own generator, the chunk plan
(``unroll``, and one-step chunks for a tail it does not divide and at
every logged step), the records' copy-out and the logging are what the
card runs, with each chunk's body called eagerly instead of replayed.
It must give the eager loop's records, final state and generator state
bit for bit, and with injected noise ``pmpx``'s chain.  ``tests/test_torch_gpu.py`` holds the captured chain
to the eager loop on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pmpx.samplers import pmp as jpmp  # noqa: E402
from pmpx.samplers.base import run_chain as jrun_chain  # noqa: E402
from pmpx.targets.linreg import BayesLinReg as JLinReg  # noqa: E402
from pmpx.targets.linreg import make_synthetic_linreg  # noqa: E402
from pmpx_torch import profiling  # noqa: E402
from pmpx_torch.interop import linreg_from_numpy, pmp_config_from_jax  # noqa: E402
from pmpx_torch.samplers import base, mh, mp, pmp, psp  # noqa: E402
from pmpx_torch.samplers.base import (  # noqa: E402
    CompiledChain, compile_chain, eager_reason, run_chain, run_chain_eager,
)

N_DATA = 512


@pytest.fixture(scope="module")
def target():
    x, y = np.random.default_rng(0).normal(size=(2, N_DATA)).astype(
        np.float32)
    y = -1.0 + 2.0 * x + 0.5 * y
    return linreg_from_numpy(x, y, temper=0.05, method="sweep",
                             device="cpu")


SAMPLERS = {
    "pmp_binary": lambda t: pmp.make_superstep(
        t, pmp.PMPConfig(N=1, depth=3, step_size=0.05)),
    "pmp_general": lambda t: pmp.make_superstep(
        t, pmp.PMPConfig(N=3, depth=2, step_size=0.05,
                         selection="all_first")),
    "mp": lambda t: mp.make_superstep(
        t, mp.MPConfig(N=7, step_size=0.05, selection="single")),
    "psp": lambda t: psp.make_superstep(
        t, psp.PSPConfig(P=8, step_size=0.05)),
    "mh": lambda t: mh.make_superstep(t, mh.MHConfig(step_size=0.05)),
}

COLLECTS = {
    "out": None,
    "tuple": lambda s, o: (s, o["root_logp"]),
    "pytree": lambda s, o: {"state": s, "pair": (o["samples"][..., 0, :],
                                                 o["log_accept"])},
}


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _equal(a, b):
    la, lb = base._leaves(a), base._leaves(b)
    assert len(la) == len(lb)
    assert type(a) is type(b)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


def _chain(sup, collect, state0, gen, unroll=None):
    return CompiledChain(sup, gen, state0, collect, unroll, capture=False)


@pytest.mark.parametrize("name", sorted(SAMPLERS))
@pytest.mark.parametrize("unroll", [1, 3, 7, None])
@pytest.mark.parametrize("chains", [None, 8])
def test_runner_equals_the_eager_loop(target, name, unroll, chains):
    """7 supersteps as unroll-step chunks (1, 3 with a tail of 1, all 7 in
    one; None, which is 1 here), one chain or a batch of 8: the eager
    loop's records, final state and generator state, bit for bit."""
    if name == "mh" and chains is None and unroll == 3:
        collect = COLLECTS["pytree"]
    else:
        collect = COLLECTS["tuple"] if unroll == 3 else None
    sup = SAMPLERS[name](target)
    th0 = torch.tensor([0.0, 0.0, 1.0])
    if chains:
        th0 = th0 + 0.1 * torch.randn((chains, 3), generator=_gen(9))
    ga, gb = _gen(5), _gen(5)
    fa, ra = run_chain_eager(sup, ga, th0, 7, collect=collect)
    fb, rb = _chain(sup, collect, th0, gb, unroll).run(gb, th0, 7)
    _equal(fa, fb)
    _equal(ra, rb)
    assert torch.equal(ga.get_state(), gb.get_state())
    # run_chain and compile_chain run the eager loop on the CPU, with any
    # unroll
    gc = _gen(5)
    fc, rc = run_chain(sup, gc, th0, 7, collect=collect, unroll=unroll)
    _equal(fa, fc)
    _equal(ra, rc)
    chain = compile_chain(sup, gc, th0, collect, unroll)
    assert chain.reason == "the state is not on a CUDA device"
    gd = _gen(5)
    fd, rd = chain.run(gd, th0, 7)
    _equal(fa, fd)
    _equal(ra, rd)


@pytest.mark.parametrize("collect", sorted(COLLECTS))
def test_runner_chains_across_calls_and_tails(target, collect, monkeypatch):
    """One chain, run twice: runs of 5, then 4 (unroll 3: step 0 eager,
    then chunks 3+1; then 3+1) equal one eager run of 9.  The first run
    captures the 3- and the 1-step chunk, once each; the second only
    replays."""
    col = COLLECTS[collect]
    sup = SAMPLERS["pmp_general"](target)
    th0 = torch.tensor([0.0, 0.0, 1.0])
    ga, gb = _gen(11), _gen(11)
    fa, ra = run_chain_eager(sup, ga, th0, 9, collect=col)
    captures = []
    capture = CompiledChain._capture
    monkeypatch.setattr(CompiledChain, "_capture", lambda self, k: (
        captures.append(k), capture(self, k))[1])
    chain = _chain(sup, col, th0, gb, 3)
    assert not chain.chunks
    f1, r1 = chain.run(gb, th0, 5)
    assert captures == [3, 1] and sorted(chain.chunks) == [1, 3]
    chunks = dict(chain.chunks)
    f2, r2 = chain.run(gb, f1, 4)
    assert captures == [3, 1] and chain.chunks == chunks
    _equal(fa, f2)
    for a, x, y in zip(base._leaves(ra), base._leaves(r1),
                       base._leaves(r2)):
        assert torch.equal(a, torch.cat([x, y]))
    assert torch.equal(ga.get_state(), gb.get_state())


@pytest.mark.parametrize("t1_us,num_steps,want", [
    (57.0, 64, 32), (43.0, 64, 32), (62.5, 64, 32), (31.0, 64, 64),
    (7700.0, 8, 1), (880_000.0, 4, 1), (57.0, 4, 4), (57.0, 20, 16),
    (57.0, 1, 1), (2000.0, 64, 1), (1000.0, 64, 2), (0.0, 1000, 64),
])
def test_unroll_for(t1_us, num_steps, want):
    """The supersteps a replay covers: the largest power of two <= 64
    and <= the first run's steps whose card time stays within 2 ms."""
    assert base.unroll_for(t1_us, num_steps) == want


def test_unroll_none_is_one_off_the_card(target):
    """unroll=None resolves to 1 where nothing is captured: capture=False,
    a declared-eager superstep, a state off the card; an explicit unroll
    stays as given."""
    sup = SAMPLERS["mh"](target)
    th0 = torch.tensor([0.0, 0.0, 1.0])
    assert CompiledChain(sup, None, th0, capture=False).unroll == 1
    assert CompiledChain(sup, None, th0, unroll=5, capture=False).unroll == 5
    assert compile_chain(sup, None, th0).unroll == 1
    declared = base.declare_eager(lambda g, s: (s + 1, s), "a test's reason")
    chain = compile_chain(declared, None, th0)
    assert chain.reason == "a test's reason" and chain.unroll == 1
    _, recs = chain.run(None, th0, 3)
    assert torch.equal(recs[:, 0], torch.tensor([0.0, 1.0, 2.0]))


def test_first_run_chooses_its_unroll(target, monkeypatch):
    """The first run of a chain left to choose (here on the CPU, its card
    time read as 57 µs): step 0, one untimed and 4 timed one-step chunks,
    then 32-step chunks for the rest of the run and the later ones, with a
    tail of one-step chunks; runs of 64, 64 and 37 equal one eager run of
    165 bit for bit, and the counters count every chunk."""
    sup = SAMPLERS["pmp_general"](target)
    th0 = torch.tensor([0.0, 0.0, 1.0])
    col = COLLECTS["tuple"]
    ga, gb = _gen(21), _gen(21)
    fa, ra = run_chain_eager(sup, ga, th0, 165, collect=col)
    timed, captures = [], []
    capture = CompiledChain._capture
    monkeypatch.setattr(CompiledChain, "_capture", lambda self, k: (
        captures.append(k), capture(self, k))[1])

    def card_us(self, replay, n, dev):
        timed.append(n)
        for _ in range(n):
            replay(1)
        return 57.0

    monkeypatch.setattr(CompiledChain, "_card_us", card_us)
    chain = _chain(sup, col, th0, gb)
    chain.unroll = None
    before = dict(profiling.counters)
    runs = []
    th = th0
    for n in (64, 64, 37):
        th, recs = chain.run(gb, th, n)
        runs.append(recs)
    assert timed == [4] and captures == [1, 32] and chain.unroll == 32
    _equal(fa, th)
    for a, *parts in zip(base._leaves(ra), *map(base._leaves, runs)):
        assert torch.equal(a, torch.cat(parts))
    assert torch.equal(ga.get_state(), gb.get_state())
    # 1 + 4 + (32 + 26 x 1) in the first run, 2 x 32, 32 + 5 x 1
    replays = profiling.counters["replays"] - before["replays"]
    steps = (profiling.counters["replayed_supersteps"]
             - before["replayed_supersteps"])
    assert (replays, steps) == (5 + 27 + 2 + 6, 164)


def test_chain_runs_only_its_state_layout():
    """A compiled chain runs states laid out as the one it was compiled
    for (shape, dtype, device, structure), and raises on another."""
    def sup(g, s):
        return s + 1.0, s

    chain = _chain(sup, lambda s, o: s, torch.zeros(3), None)
    chain.run(None, torch.ones(3), 2)
    for other in (torch.zeros(4), torch.zeros(3, dtype=torch.float64),
                  (torch.zeros(3),)):
        with pytest.raises(ValueError, match="another state layout"):
            chain.run(None, other, 2)


def test_plan():
    assert base._plan(0, 7, 1, None) == [1] * 7
    assert base._plan(0, 7, 3, None) == [3, 3, 1]
    assert base._plan(1, 7, 3, None) == [3, 3]
    assert base._plan(0, 7, 7, None) == [7]
    assert base._plan(0, 12, 3, 5) == [1, 3, 1, 1, 3, 1, 1, 1]
    assert base._plan(1, 12, 3, 5) == [3, 1, 1, 3, 1, 1, 1]
    assert base._plan(0, 30, 1, 10) == [1] * 30
    for start, n, k, e in ((0, 30, 4, 10), (1, 31, 7, 3), (1, 5, 9, 2)):
        plan = base._plan(start, n, k, e)
        assert sum(plan) == n - start and set(plan) <= {1, k}
        ends = set(start + np.cumsum(plan) - 1)
        assert {s for s in range(start, n) if s % e == 0} <= ends


def _replaying(sup, eps, u):
    """``sup`` fed step i's injected (eps, u) through a step counter on
    the device, as a captured superstep must take them (no host index)."""
    i = torch.zeros((), dtype=torch.long)

    def step(g, theta):
        k = i.reshape(1)
        out = sup(g, theta, eps=eps.index_select(0, k)[0],
                  u=u.index_select(0, k)[0])
        i.add_(1)
        return out

    return step, i


@pytest.mark.parametrize("unroll", [1, 3, 20])
def test_runner_replays_pmpx_noise(unroll):
    """20 supersteps, depth 4, all_first, each step's eps and uniforms
    from pmpx's key splits (tests/test_torch_slice.py's replay), through
    the runner's chunks: pmpx's roots, and its states within 1e-5."""
    x, y = make_synthetic_linreg(jax.random.key(0), 4096)
    jt = JLinReg(x, y, temper=0.01, method="xla")
    tt = linreg_from_numpy(np.array(x), np.array(y), temper=0.01,
                           method="sweep", device="cpu")
    jcfg = jpmp.PMPConfig(N=1, depth=4, step_size=0.05,
                          selection="all_first")
    P, steps = jcfg.P, 20
    key = jax.random.key(42)
    theta0 = jnp.array([0.0, 0.0, 1.0], jnp.float32)
    jsup = jpmp.make_superstep(jt, jcfg)
    jfinal, (jstates, jroots) = jax.jit(lambda k, t: jrun_chain(
        jsup, k, t, steps, collect=lambda s, o: (s, o["root_index"])))(
            key, theta0)
    eps, u = [], []
    for k in jax.random.split(key, steps):  # run_chain's per-step keys
        k_eps, k_draw, _, _ = jax.random.split(k, 4)
        eps.append(jcfg.step_size * jax.random.normal(k_eps, (P, 3)))
        u.append(jax.random.uniform(k_draw, (P,)))
    step, _ = _replaying(
        pmp.make_superstep(tt, pmp_config_from_jax(jcfg)),
        torch.tensor(np.array(eps)), torch.tensor(np.array(u)))
    th = torch.tensor(np.array(theta0))
    final, (states, roots) = _chain(
        step, lambda s, o: (s, o["root_index"]), th, None, unroll).run(
            None, th, steps)
    np.testing.assert_array_equal(roots.numpy(), np.asarray(jroots))
    assert len(set(roots.tolist())) > 1  # the chain moved
    np.testing.assert_allclose(states.numpy(), np.asarray(jstates),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), atol=1e-5)


@pytest.mark.parametrize("unroll", [1, 4])
def test_runner_logs_at_pmpx_steps(target, unroll):
    """log_every=10 over 30 steps: log_fn sees steps [0, 10, 20] (pmpx's,
    tests/test_torch_parallel.py), each with the state after that step and
    its out, as copies that later replays do not overwrite."""
    sup = SAMPLERS["mh"](target)
    th0 = torch.tensor([0.0, 0.0, 1.0])
    seen = []
    g = _gen(0)
    final, trace = _chain(sup, lambda s, o: s, th0, g, unroll).run(
        g, th0, 30, 10,
        lambda step, st, o: seen.append((step, st, o["samples"])))
    assert [s for s, _, _ in seen] == [0, 10, 20]
    for step, st, samples in seen:
        assert torch.equal(st, trace[step])
        assert torch.equal(samples[0], trace[step])
    g2 = _gen(0)
    again, trace2 = run_chain_eager(sup, g2, th0, 30,
                                    collect=lambda s, o: s)
    assert torch.equal(again, final) and torch.equal(trace2, trace)


class _FakeMesh:
    def get_group(self, axis):
        return None


def test_declared_eager_supersteps(target, monkeypatch):
    """The supersteps whose target issues collectives say so where they
    are built, through Tempered and every maker; the others have no
    reason, apart from their CPU state."""
    import torch.distributed as dist

    from pmpx_torch.models import MnistMLP
    from pmpx_torch.parallel import (
        ShardedLinReg, ShardedNNPosterior, make_tree_sharded_superstep,
    )
    from pmpx_torch.samplers import hmc
    from pmpx_torch.samplers.base import Tempered
    from pmpx_torch.targets.nn import NNPosterior

    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1)
    x = torch.linspace(-1, 1, 256)
    lin = ShardedLinReg(x, 2 * x, 256, mesh=_FakeMesh())
    tmpl = NNPosterior(MnistMLP(), torch.zeros((8, 28, 28)),
                       torch.zeros(8, dtype=torch.long), device="cpu")
    nn = ShardedNNPosterior(tmpl, torch.zeros((8, 28, 28)),
                            torch.zeros(8, dtype=torch.long), 8,
                            mesh=_FakeMesh())
    cfg = pmp.PMPConfig(N=1, depth=2, step_size=0.1)
    declared = {
        "ShardedLinReg pmp": pmp.make_superstep(lin, cfg),
        "ShardedLinReg mh": mh.make_superstep(lin, mh.MHConfig(0.1)),
        "Tempered ShardedLinReg": pmp.make_superstep(Tempered(lin, 0.5),
                                                     cfg),
        "ShardedNNPosterior sp_hmc": hmc.make_superstep(
            nn, hmc.HMCConfig(step_size=0.1)),
        "tree-sharded": make_tree_sharded_superstep(target, cfg,
                                                    mesh=_FakeMesh()),
    }
    for label, sup in declared.items():
        why = eager_reason(sup)
        assert why and ("all-reduces" in why or "all-gathers" in why), label
    for name, make in SAMPLERS.items():
        sup = make(target)
        assert eager_reason(sup) is None, name
        assert eager_reason(sup, torch.zeros(3)) == (
            "the state is not on a CUDA device")
    assert eager_reason(hmc.make_superstep(
        target, hmc.PMPHMCConfig(depth=2, step_size=0.1))) is None
    assert eager_reason(pmp.make_superstep(tmpl, cfg)) is None


class _OnCuda(torch.Tensor):
    """A CPU tensor that says it lies on a card (a mixed state, here)."""

    @property
    def is_cuda(self):
        return True


def test_a_state_that_mixes_devices_raises(target):
    """A state with leaves on a card and off it is neither captured nor
    run as the loop: eager_reason, run_chain and compile_chain raise,
    naming the superstep, even for a declared-eager superstep."""
    sup = SAMPLERS["mh"](target)
    mixed = (torch.zeros(3).as_subclass(_OnCuda), torch.zeros(3))
    assert eager_reason(sup, (torch.zeros(3), torch.zeros(3))) == (
        "the state is not on a CUDA device")
    with pytest.raises(ValueError, match="mixes CUDA tensors"):
        eager_reason(sup, mixed)
    with pytest.raises(ValueError, match="make_superstep"):
        run_chain(sup, _gen(0), mixed, 2)
    with pytest.raises(ValueError, match="mixes CUDA tensors"):
        compile_chain(sup, _gen(0), mixed)
    declared = base.declare_eager(lambda g, s: (s, s), "a test's reason")
    with pytest.raises(ValueError, match="mixes CUDA tensors"):
        run_chain(declared, None, mixed, 2)


def test_run_chain_checks_its_arguments(target):
    sup = SAMPLERS["mh"](target)
    th0 = torch.tensor([0.0, 0.0, 1.0])
    with pytest.raises(ValueError, match="unroll"):
        run_chain(sup, _gen(0), th0, 3, unroll=0)
    with pytest.raises(ValueError, match="num_steps"):
        run_chain(sup, _gen(0), th0, 0)
    with pytest.raises(ValueError, match="unroll"):
        compile_chain(sup, _gen(0), th0, unroll=0)
    with pytest.raises(TypeError, match="tensors"):
        _chain(sup, None, (th0, 3), None)


def test_runtime_build_force_rebuilds(tmp_path):
    """pmpx.runtime.build's force=True: the library is compiled again (a
    new file renamed into place) and still loads."""
    import ctypes
    import shutil

    from pmpx_torch import runtime

    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("needs g++")
    assert runtime.build()
    so = runtime.library_path()
    before = so.stat()
    assert runtime.build() and so.stat().st_ino == before.st_ino
    assert runtime.build(force=True)
    after = so.stat()
    assert (after.st_ino, after.st_mtime_ns) != (before.st_ino,
                                                 before.st_mtime_ns)
    ctypes.CDLL(str(so))
