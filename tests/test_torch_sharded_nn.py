"""The data-sharded NN posteriors and sync-BN (``pmpx_torch.parallel.
sharded_nn``, ``parallel.mesh.psum``) against ``pmpx``'s on its 8-device
virtual CPU mesh (``tests/test_sharded_nn.py``), on a world of 4 gloo ranks
spawned here (``init_method="file://..."`` under the test's tmp_path).

Each rank holds a shard of 16 of the 64 images; the models are MnistMLP,
LeNet (remat off and on), PackedLeNet, PackedMnistCNN and BayesMLP.  The
ranks write their results with ``torch.save``; the tests compare them with
``pmpx``'s unsharded and ``shard_map``-sharded posteriors, and with the
port's unsharded one, which run in the test process.  The world is joined
with a timeout and killed on expiry, so a hang fails these tests alone.
JAX and ``pmpx`` are imported inside the tests and the fixture, so the
ranks, which import this module, import neither.
"""

import os
import subprocess
import sys
import warnings
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import torch.distributed as dist  # noqa: E402
from torch.func import grad, vmap  # noqa: E402

from pmpx_torch import parallel as tpar  # noqa: E402
from pmpx_torch.config import SamplerSpec  # noqa: E402
from pmpx_torch.models import (  # noqa: E402
    BayesMLP, LeNet, MnistMLP, PackedLeNet, PackedMnistCNN,
)
from pmpx_torch.parallel import mesh as tmesh  # noqa: E402
from pmpx_torch.samplers.base import run_chain  # noqa: E402
from pmpx_torch.targets.nn import NNPosterior  # noqa: E402

HERE = Path(__file__).resolve().parent
WORLD = 4
N = 64  # images, 16 a rank
JOIN_S = 150  # the world's join; killed on expiry
# pmpx's tolerances (tests/test_sharded_nn.py:62-69)
VAL_RTOL, VAL_ATOL = 2e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 5e-3, 1e-5
BNN_HIDDEN = 32
# the superstep (tests/test_sharded_nn.py:76-106): MnistMLP over 32
# images, 3 supersteps
SS_N, SS_STEPS = 32, 3
SS_SPEC = dict(algo="pmp", N=1, depth=2, step_size=1e-3, selection="single",
               stabilizer="zscore")

# name: (port model, image shape, stochastic)
CASES = {
    "mlp": (lambda: MnistMLP(), (28, 28), False),
    "lenet": (lambda: LeNet(), (32, 32, 3), False),
    "lenet_remat": (lambda: LeNet(remat=True), (32, 32, 3), False),
    "packed_lenet": (lambda: PackedLeNet(), (32, 32, 3), False),
    "packed_cnn": (lambda: PackedMnistCNN(), (28, 28), False),
    "bnn": (lambda: BayesMLP(hidden=BNN_HIDDEN), (28, 28), True),
}


def _images(shape, n=N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n,) + shape).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int64))


def _port(name, X, Y, **kw):
    make, _, stochastic = CASES[name]
    return NNPosterior(make(), X, Y, stochastic=stochastic, device="cpu",
                       **kw)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _routes():
    return tmesh.routes["all_reduce"]["direct"]


# -- a world of gloo ranks ---------------------------------------------


def spawn_world(tmp_path, world, entry, *args):
    """``world`` ranks of ``entry`` ("module:function", a module of this
    directory) as child processes, each called with (rank, world,
    init_file, out, *args); returns the Popen objects and result files."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(HERE.parent), str(HERE), os.environ.get("PYTHONPATH", "")]))
    mod, fn = entry.split(":")
    code = (f"import sys, {mod} as m; m.{fn}(*sys.argv[1:])")
    init = tmp_path / f"init_{fn}"
    procs, outs = [], []
    for r in range(world):
        out = tmp_path / f"{fn}_rank{r}.pt"
        log = open(tmp_path / f"{fn}_rank{r}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(world), str(init),
             str(out), *map(str, args)],
            env=env, stdout=log, stderr=subprocess.STDOUT))
        log.close()
        outs.append(out)
    return procs, outs


def join_world(procs, outs, timeout=JOIN_S):
    """Wait for every rank (``timeout`` in all), kill the world on expiry,
    and load each rank's results; fails with the ranks' logs otherwise."""
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    logs = "\n".join(Path(str(o)[:-3] + ".log").read_text() for o in outs)
    assert all(p.returncode == 0 for p in procs), logs
    return [torch.load(o, weights_only=False) for o in outs]


def init_rank(rank, world, init_file):
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    return rank, world


# -- the ranks ---------------------------------------------------------


def _psum_alone(group, r):
    """The collective alone, on rank-dependent data, under vmap, grad and
    vmap(grad): each result and the collectives it took."""
    res = {}
    x = torch.arange(6.0).reshape(3, 2) * (r + 1)

    def f(t):
        return (tmesh.psum(t * (r + 1), group) ** 2).sum()

    t = torch.tensor([1.0, -2.0])
    T = torch.stack([t, 2 * t, -t, 0.5 * t])
    for name, fn in (
            ("vmap", lambda: vmap(lambda a: tmesh.psum(a, group))(x)),
            ("grad", lambda: grad(f)(t)),
            ("vmap_grad", lambda: vmap(grad(f))(T)),
            ("vmap_grad_chunk2", lambda: vmap(grad(f), chunk_size=2)(T))):
        before = _routes()
        res[name] = (fn(), _routes() - before)
    return res


def _posterior_results(inp, name, shard, mesh):
    X, Y, Theta = inp[name]
    template = _port(name, X, Y)
    sl = slice(shard * (N // WORLD), (shard + 1) * (N // WORLD))
    s = tpar.ShardedNNPosterior.from_posterior(template, X[sl], Y[sl], N,
                                               mesh=mesh)
    out = {}
    kw = {"generator": _gen(0)} if template.stochastic else {}
    before = _routes()
    out["logp"] = s.log_prob_batch(Theta, **kw)
    out["logp_calls"] = _routes() - before
    kw = {"generator": _gen(0)} if template.stochastic else {}
    before = _routes()
    out["vg"] = s.value_and_grad_batch(Theta, **kw)
    out["vg_calls"] = _routes() - before
    out["acc"] = s.accuracy(Theta[0], **kw)
    out["single"] = s.log_prob(Theta[1], **kw)
    if name in ("lenet", "packed_lenet"):  # one reduce per chunk
        s.proposal_chunk = 1
        before = _routes()
        out["chunked_vg"] = s.value_and_grad_batch(Theta)
        out["chunked_vg_calls"] = _routes() - before
    if template.stochastic:  # real noise, one generator state everywhere
        out["noisy_logp"] = s.log_prob_batch(inp["bnn_noisy"],
                                             generator=_gen(5))
        out["noisy_vg"] = s.value_and_grad_batch(inp["bnn_noisy"],
                                                 generator=_gen(6))
    return out


def _superstep(inp, shard, mesh):
    X, Y = inp["ss_data"]
    sl = slice(shard * (SS_N // WORLD), (shard + 1) * (SS_N // WORLD))
    s = tpar.ShardedNNPosterior.from_posterior(
        _port("mlp", X, Y), X[sl], Y[sl], SS_N, mesh=mesh)
    sup = SamplerSpec(**SS_SPEC).build(s)
    return run_chain(sup, _gen(3), inp["ss_theta0"], SS_STEPS)[0]


def _rank_main(rank, world, init_file, out, inputs):
    rank, world = init_rank(rank, world, init_file)
    inp = torch.load(inputs)
    mesh = tmesh.make_mesh(data=world)
    shard = mesh.get_local_rank(tmesh.AXIS_DATA)
    res = {"psum": _psum_alone(mesh.get_group(tmesh.AXIS_DATA), rank)}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for name in CASES:
            res[name] = _posterior_results(inp, name, shard, mesh)
        res["superstep"] = _superstep(inp, shard, mesh)
    res["warnings"] = [str(w.message) for w in caught]
    res["routes"] = tmesh.routes
    torch.save(res, out)
    dist.destroy_process_group()


def bn_rank(rank, world, init_file, out, inputs):
    """One rank of convpack's sync-BN (tests/test_torch_convpack.py): its
    shard of the batch normalised with the group's statistics, and the
    gradients of sum(out * w) with respect to its shard, the scale and the
    bias (those two summed over the group)."""
    from pmpx_torch.kernels import convpack as cp

    rank, world = init_rank(rank, world, init_file)
    inp = torch.load(inputs)
    group = tmesh.make_mesh(data=world).get_group(tmesh.AXIS_DATA)
    b = inp["x"].shape[0] // world
    x, w = (inp[k][rank * b:(rank + 1) * b] for k in ("x", "w"))
    g = cp.Grid(*inp["grid"])

    def loss(x, scale, bias):
        return (cp.batchnorm(x, scale, bias, g, axis_name=group) * w).sum()

    before = _routes()
    y = cp.batchnorm(x, inp["scale"], inp["bias"], g, axis_name=group)
    calls = _routes() - before
    gx, gs, gb = grad(loss, argnums=(0, 1, 2))(x, inp["scale"], inp["bias"])
    torch.save({"y": y, "gx": gx, "gscale": tmesh.all_reduce_sum(gs, group),
                "gbias": tmesh.all_reduce_sum(gb, group), "calls": calls},
               out)
    dist.destroy_process_group()


# -- pmpx's side, in this process --------------------------------------


def _pmpx_cases():
    """pmpx's posterior over the same images for each case, its P = 3
    thetas, and its unsharded and 4-device shard_map results.

    The thetas are tests/test_sharded_nn.py's (pmpx's init and two
    scalings of it), each moved by 0.02 N(0, 1) noise: at pmpx's exact
    init one of MnistCNN's Dense_0 pre-activations (image 32, unit 220) is
    -1.8e-7, so f32 rounding decides its ReLU, and the two libraries'
    *unsharded* gradients already differ there (by 9.7e-4 in 1368
    entries), whatever the sharding."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from pmpx import models as jm
    from pmpx.parallel import make_mesh as jmake_mesh
    from pmpx.parallel.sharded_nn import ShardedNNPosterior as JSharded
    from pmpx.targets.nn import NNPosterior as JPost

    jmodels = {"mlp": jm.MnistMLP(), "lenet": jm.LeNet(),
               "lenet_remat": jm.LeNet(remat=True),
               "packed_lenet": jm.PackedLeNet(),
               "packed_cnn": jm.PackedMnistCNN(),
               "bnn": jm.BayesMLP(hidden=BNN_HIDDEN)}
    mesh = jmake_mesh(chains=1, data=WORLD)
    key = jax.random.key(0)
    out = {}
    for name, (_, shape, stochastic) in CASES.items():
        X, Y = _images(shape)
        t = JPost(jmodels[name], jnp.asarray(X), jnp.asarray(Y),
                  stochastic=stochastic, init_key=jax.random.key(2))
        t0 = t.init_theta()
        Theta = jnp.stack([t0, 0.95 * t0, 1.1 * t0]) + 0.02 * jnp.asarray(
            np.random.default_rng(1).standard_normal((3, t.d)), jnp.float32)
        if stochastic:  # every log-sigma at -30: no noise shows
            Theta = jnp.stack([t.theta_from_params(
                jax.tree_util.tree_map_with_path(
                    lambda path, v: (jnp.full_like(v, -30.0)
                                     if "log_sigma" in path[-1].key else v),
                    t._unravel(th))) for th in Theta])
        want = {"logp": jax.jit(t.log_prob_batch)(Theta, key),
                "vg": jax.jit(t.value_and_grad_batch)(Theta, key),
                "acc": jax.jit(t.accuracy)(Theta[0], None, None, key)}

        def body(x_l, y_l, Th, k, t=t):
            s = JSharded.from_posterior(t, x_l, y_l, n_total=N)
            return (s.log_prob_batch(Th, k), s.value_and_grad_batch(Th, k),
                    s.accuracy(Th[0], key=k))

        sharded = jax.jit(shard_map(
            body, mesh=mesh, in_specs=(P("data"), P("data"), P(), P()),
            out_specs=(P(), P(), P()), check_vma=False))(
            jnp.asarray(X), jnp.asarray(Y), Theta, key)
        params = [jax.tree.map(np.asarray, t._unravel(th)) for th in Theta]
        out[name] = (X, Y, params, jax.tree.map(np.asarray, want),
                     jax.tree.map(np.asarray, dict(zip(
                         ("logp", "vg", "acc"), sharded))))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """pmpx's results, the port's unsharded ones, and the 4 ranks'."""
    from pmpx_torch import interop as tinterop

    tmp = tmp_path_factory.mktemp("sharded_nn")
    ref = _pmpx_cases()
    inputs, port = {}, {}
    for name, (X, Y, params, _, _) in ref.items():
        tpost = _port(name, X, Y)
        Theta = torch.stack([tinterop.nn_theta_from_params(tpost, p)
                             for p in params])
        inputs[name] = (torch.from_numpy(X), torch.from_numpy(Y), Theta)
        kw = {"generator": _gen(0)} if tpost.stochastic else {}
        port[name] = {"logp": tpost.log_prob_batch(Theta, **kw),
                      "vg": tpost.value_and_grad_batch(Theta, **kw)}
    bnn = _port("bnn", *ref["bnn"][:2])
    noisy = bnn.init_theta() + 0.01 * torch.randn((3, bnn.d),
                                                  generator=_gen(1))
    inputs["bnn_noisy"] = noisy
    port["bnn_noisy"] = (bnn.log_prob_batch(noisy, generator=_gen(5)),
                         bnn.value_and_grad_batch(noisy, generator=_gen(6)))
    X, Y = _images((28, 28), SS_N, seed=5)
    inputs["ss_data"] = (torch.from_numpy(X), torch.from_numpy(Y))
    mlp = _port("mlp", X, Y)
    inputs["ss_theta0"] = mlp.init_theta()
    port["superstep"] = run_chain(SamplerSpec(**SS_SPEC).build(mlp), _gen(3),
                                  mlp.init_theta(), SS_STEPS)[0]
    torch.save(inputs, tmp / "inputs.pt")
    ranks = join_world(*spawn_world(tmp, WORLD,
                                    "test_torch_sharded_nn:_rank_main",
                                    tmp / "inputs.pt"))
    return ref, inputs, port, ranks


# -- the tests ---------------------------------------------------------


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name", list(CASES))
def test_log_prob_batch_matches_pmpx(world, name):
    """log_prob_batch over 4 ranks: pmpx's unsharded and shard_map-sharded
    values, and the port's unsharded ones, within pmpx's tolerance; the
    same on every rank."""
    ref, _, port, ranks = world
    _, _, _, want, jsharded = ref[name]
    for res in ranks:
        got = res[name]["logp"]
        _close(got, want["logp"], VAL_RTOL, VAL_ATOL)
        _close(got, jsharded["logp"], VAL_RTOL, VAL_ATOL)
        _close(got, port[name]["logp"], VAL_RTOL, VAL_ATOL)
        assert torch.equal(got, ranks[0][name]["logp"])
        # the single density is the batch's row, to rounding
        _close(res[name]["single"], want["logp"][1], VAL_RTOL, VAL_ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_value_and_grad_batch_matches_pmpx(world, name):
    """value_and_grad_batch over 4 ranks: values within rtol 2e-5,
    gradients within rtol 5e-3 / atol 1e-5 of pmpx's unsharded and sharded
    posteriors and of the port's unsharded one.  A BatchNorm gradient with
    an identity adjoint, or an outer sum taken twice, misses by far more."""
    ref, _, port, ranks = world
    _, _, _, want, jsharded = ref[name]
    for res in ranks:
        v, g = res[name]["vg"]
        for ref_v, ref_g in (want["vg"], jsharded["vg"], port[name]["vg"]):
            _close(v, ref_v, VAL_RTOL, VAL_ATOL)
            _close(g, ref_g, GRAD_RTOL, GRAD_ATOL)
        assert torch.equal(g, ranks[0][name]["vg"][1])


@pytest.mark.parametrize("name", list(CASES))
def test_accuracy_matches_pmpx(world, name):
    ref, _, _, ranks = world
    _, _, _, want, jsharded = ref[name]
    for res in ranks:
        assert float(res[name]["acc"]) == pytest.approx(float(want["acc"]),
                                                        abs=1e-6)
        assert float(res[name]["acc"]) == pytest.approx(
            float(jsharded["acc"]), abs=1e-6)


def test_stochastic_shards_share_the_noise(world):
    """BayesMLP with its noise: every rank draws the same networks from
    one generator state, so the 4 shards give the port's unsharded
    posterior on the same generator."""
    _, _, port, ranks = world
    want_lp, (want_v, want_g) = port["bnn_noisy"]
    for res in ranks:
        _close(res["bnn"]["noisy_logp"], want_lp, VAL_RTOL, VAL_ATOL)
        v, g = res["bnn"]["noisy_vg"]
        _close(v, want_v, VAL_RTOL, VAL_ATOL)
        _close(g, want_g, GRAD_RTOL, GRAD_ATOL)


# per evaluation of P = 3 proposals in one chunk: BatchNorms x collectives
# each (LeNet's flax form 1, the packed two-pass form 2), in each pass
# (remat's backward recomputes the block's forward), plus the outer sums
# of the values (and of the gradients)
CALLS = {"mlp": (1, 2), "lenet": (3, 6), "lenet_remat": (3, 8),
         "packed_lenet": (5, 10), "packed_cnn": (1, 2), "bnn": (1, 2)}


@pytest.mark.parametrize("name", list(CASES))
def test_one_collective_per_chunk_and_batch_norm(world, name):
    """Every collective under vmap goes through psum's own vmap rule: one
    per BatchNorm and pass for the whole chunk of proposals, never one per
    proposal (a per-sample fallback would also warn); with
    proposal_chunk=1, one per chunk."""
    _, _, _, ranks = world
    for res in ranks:
        assert (res[name]["logp_calls"], res[name]["vg_calls"]) == CALLS[
            name]
        assert not [w for w in res["warnings"]
                    if "ollective" in w or "batching rule" in w]
        assert res["routes"]["all_reduce"]["host"] == 0
        if "chunked_vg" in res[name]:
            bn = CALLS[name][1] - 2
            assert res[name]["chunked_vg_calls"] == 3 * bn + 2
            v, g = res[name]["chunked_vg"]
            _close(v, res[name]["vg"][0], VAL_RTOL, 0)
            _close(g, res[name]["vg"][1], 0,
                   1e-5 * float(g.abs().max()))


def test_sharded_superstep_matches_the_unsharded_one(world):
    """A PMP superstep over the 4-rank sharded MnistMLP (tests/
    test_sharded_nn.py:76-106): the same state on every rank, the port's
    unsharded chain's from the same generator."""
    _, inputs, port, ranks = world
    want = port["superstep"]
    assert not torch.equal(want, inputs["ss_theta0"])  # the chain moved
    for res in ranks:
        assert torch.isfinite(res["superstep"]).all()
        assert torch.equal(res["superstep"], ranks[0]["superstep"])
        torch.testing.assert_close(res["superstep"], want, rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("case", ["vmap", "grad", "vmap_grad",
                                  "vmap_grad_chunk2"])
def test_psum_under_vmap_and_grad(world, case):
    """psum of rank-dependent values over 4 ranks: the group's sum under
    vmap (one collective for the batch, where vmap's fallback gave one per
    sample and a wrong sum), and its adjoint, the group's sum of the
    cotangents, under grad and vmap(grad) (one collective in each pass, per
    chunk)."""
    _, _, _, ranks = world
    S = sum(range(1, WORLD + 1))  # sum over ranks of (r + 1)
    t = torch.tensor([1.0, -2.0])
    T = torch.stack([t, 2 * t, -t, 0.5 * t])
    for r, res in enumerate(ranks):
        got, calls = res["psum"][case]
        if case == "vmap":
            want, want_calls = torch.arange(6.0).reshape(3, 2) * S, 1
        else:
            # f = |S t|^2 on every rank; d f_r / d t = (r+1) psum(2 S t)
            per = lambda a: (r + 1) * WORLD * 2 * S * a  # noqa: E731
            want = per(t) if case == "grad" else per(T)
            want_calls = {"grad": 2, "vmap_grad": 2,
                          "vmap_grad_chunk2": 4}[case]
        assert torch.equal(got, want), (case, r)
        assert calls == want_calls


def test_psum_names_the_group_it_needs():
    with pytest.raises(TypeError, match=r"mesh.get_group\('data'\)"):
        tmesh.psum(torch.ones(2), "data")


@pytest.mark.parametrize("name", ["lenet", "lenet_remat", "packed_lenet",
                                  "mlp"])
def test_one_rank_mesh_is_the_posterior_bit_for_bit(name):
    """data=1: the values equal NNPosterior's bit for bit (a sum over one
    rank, a mean over one rank, and -temper * (sum / n) = -temper * mean),
    and so do the gradients on the CPU."""
    mesh = tmesh.make_mesh(devices="cpu")
    X, Y = _images(CASES[name][1], 16, seed=8)
    t = _port(name, X, Y, temper=0.3)
    s = tpar.ShardedNNPosterior.from_posterior(t, X, Y, 16, mesh=mesh)
    Theta = torch.stack([t.init_theta(), 0.9 * t.init_theta()])
    assert torch.equal(s.log_prob_batch(Theta), t.log_prob_batch(Theta))
    (sv, sg), (tv, tg) = (p.value_and_grad_batch(Theta) for p in (s, t))
    assert torch.equal(sv, tv) and torch.equal(sg, tg)
    assert torch.equal(s.log_prob(Theta[1]), t.log_prob(Theta[1]))
    assert torch.equal(s.accuracy(Theta[0]), t.accuracy(Theta[0]))


def test_sharded_posterior_inherits_and_skips_the_fused_density():
    mesh = tmesh.make_mesh(devices="cpu")
    X, Y = _images((32, 32, 3), 8, seed=9)
    t = NNPosterior(LeNet(remat=True), X, Y, temper=0.5, device="cpu",
                    proposal_chunk=2)
    t._fast_batch = lambda Theta: None  # as lstm_fused.attach sets it
    s = tpar.ShardedNNPosterior.from_posterior(t, X[:4], Y[:4], 8,
                                               mesh=mesh)
    assert "ShardedNNPosterior" in tpar.__all__
    assert isinstance(s.model, LeNet) and s.model.remat
    assert s.model.bn_axis is mesh.get_group(tmesh.AXIS_DATA)
    assert t.model.bn_axis is None  # the template's model is untouched
    assert (s.temper, s.proposal_chunk, s.d, s.needs_rng) == (
        0.5, 2, t.d, False)
    assert not hasattr(s, "_fast_batch") and s.X.shape[0] == 4
    assert s.log_prob_batch(torch.stack([t.init_theta()] * 2)).shape == (2,)
    with pytest.raises(TypeError, match="mesh"):
        tpar.ShardedNNPosterior(t, X, Y, 8)


def test_every_pmpx_module_has_its_port():
    """Each module of pmpx/ has its counterpart at the same path in
    pmpx_torch/."""
    root = HERE.parent
    mods = [{p.relative_to(root / pkg) for p in (root / pkg).rglob("*.py")}
            for pkg in ("pmpx", "pmpx_torch")]
    assert mods[0] and not mods[0] - mods[1], sorted(mods[0] - mods[1])
