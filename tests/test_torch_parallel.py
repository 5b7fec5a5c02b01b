"""The mesh and the chains, data and tree axes (``pmpx_torch.parallel``)
against ``pmpx.parallel`` on its 8-device virtual CPU mesh, on worlds of
gloo ranks spawned here (``init_method="file://..."`` under the test's
tmp_path, so that the suite's workers share no port); and ``run_chain``'s
``log_every`` and the top-level names against ``pmpx``'s.

One world of 4 ranks and one process with no world serve every check
(the module fixture ``worlds``): each rank runs :func:`_rank_main`, writes
its results with ``torch.save``, and the tests compare them with
``pmpx``'s, which run in the test process.  Each world is joined with a
timeout and killed on expiry, so a hang fails these tests alone.
JAX and ``pmpx`` are imported inside the tests, so the ranks, which
import this module, import neither.
"""

import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import torch.distributed as dist  # noqa: E402

import pmpx_torch  # noqa: E402
from pmpx_torch import parallel as tpar  # noqa: E402
from pmpx_torch.experiments import multichain as tmc  # noqa: E402
from pmpx_torch.parallel import mesh as tmesh  # noqa: E402
from pmpx_torch.samplers import pmp as tpmp  # noqa: E402
from pmpx_torch.samplers.base import run_chain  # noqa: E402
from pmpx_torch.targets import Gaussian1D as TGaussian1D  # noqa: E402
from pmpx_torch.targets.linreg import BayesLinReg  # noqa: E402

HERE = Path(__file__).resolve().parent
WORLD = 4
JOIN_S = 120  # each world's join; killed on expiry
# the chains replay: 8 chains of an N = 3, depth 2 tree on Gaussian1D
# (tests/test_parallel.py:28), T supersteps
CHAINS, T, CH_P = 8, 40, 16
# states and emitted samples within 1e-5 (tests/test_torch_chains.py)
STATE_ATOL = 1e-5
# the data axis: n = 4096 over 4 shards, 16 proposals (test_parallel.py:47);
# log-densities within rtol 1e-5 of the port's unsharded sweep and of
# pmpx's float64 "suffstats", 3e-4 of pmpx's f32 "xla" sweep (ROADMAP §3,
# "f32 sweep accuracy")
N_DATA, LOGP_RTOL, XLA_RTOL = 4096, 1e-5, 3e-4
# the farm: 8 chains of binary depth 3 over n = 2048, 48 supersteps in
# chunks of 16 (test_parallel.py:217), uniforms drawn from each chain's
# generator (rng="input")
FARM_STEPS, FARM_CHUNK = 48, 16


# -- the ranks ---------------------------------------------------------


def _replaying(superstep, noise):
    """The superstep on the next step's injected noise at every call."""
    step = iter(range(noise[0].shape[1]))

    def replay(gen, theta):
        t = next(step)
        kw = dict(zip(("eps", "u", "pick"), (a[:, t] for a in noise)))
        return superstep(gen, theta, **kw)

    return replay


def _chains_cfg():
    return tpmp.PMPConfig(N=3, depth=2, step_size=1.0)


def _farm_cfg():
    return tpmp.PMPConfig(N=1, depth=3, step_size=0.05,
                          selection="all_first")


def _tree_cfg():
    return tpmp.PMPConfig(N=1, depth=4, step_size=0.05,
                          selection="all_first")


def _run_farm(inp, mesh=None):
    target = BayesLinReg(inp["farm_x"], inp["farm_y"], temper=50.0 / 2048,
                         device="cpu")
    farm = tpar.make_chain_farm_fused(target, _farm_cfg(), FARM_STEPS, mesh,
                                      chunk=FARM_CHUNK, rng="input")
    return farm(tpar.chain_generators(8, CHAINS, "cpu"), inp["farm_theta0"])


def _solo(out):
    """A process with no world: make_mesh starts one of one rank."""
    res = {}
    try:
        tmesh.make_mesh()
    except RuntimeError as e:  # the default device is the card
        res["no_card"] = str(e)
    try:
        tmesh.make_mesh(chains=2, devices="cpu")
    except ValueError as e:
        res["too_small"] = str(e)
    res["initialized_before"] = dist.is_initialized()
    mesh = tmesh.make_mesh(devices="cpu")
    res["backend"] = dist.get_backend()
    res["world"] = dist.get_world_size()
    res["names"] = list(mesh.mesh_dim_names)
    res["coordinate"] = list(mesh.get_coordinate())
    torch.save(res, out)


def _rank_main(rank, world, init_file, inputs, out):
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    if world == 1:
        return _solo(out)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    inp = torch.load(inputs)
    res = {}

    # the mesh: pmpx's error, a rank past the mesh, the coordinates
    try:
        tmesh.make_mesh(chains=2 * world)
    except ValueError as e:
        res["too_small"] = str(e)
    m3 = tmesh.make_mesh(chains=world - 1)
    res["outside"] = None if m3 is None else list(m3.get_coordinate())
    m22 = tmesh.make_mesh(chains=2, data=2)
    res["names"] = list(m22.mesh_dim_names)
    res["coordinate"] = list(m22.get_coordinate())

    # the chains axis: 8 chains over 4 ranks on pmpx's per-chain noise
    mesh = tmesh.make_mesh(chains=world)
    r = mesh.get_local_rank(tmesh.AXIS_CHAINS)
    blk = slice(r * CHAINS // world, (r + 1) * CHAINS // world)
    sup = tpmp.make_superstep(TGaussian1D(), _chains_cfg())
    noise = tuple(a[blk] for a in inp["chains_noise"])
    res["chains"] = tpar.run_chains_sharded(
        _replaying(sup, noise), 0, torch.zeros((CHAINS, 1)), T, mesh,
        collect=lambda th, o: {"theta": th, **o}, device="cpu")
    try:
        tpar.run_chains_sharded(sup, 0, torch.zeros((CHAINS + 1, 1)), 1,
                                mesh, device="cpu")
    except ValueError as e:
        res["chains_indivisible"] = str(e)
    res["farm"] = _run_farm(inp, mesh)
    try:
        tpar.run_chains_fused(
            BayesLinReg(inp["farm_x"], inp["farm_y"], device="cpu"),
            _farm_cfg(), tpar.chain_generators(8, CHAINS + 2, "cpu"),
            torch.zeros((CHAINS + 2, 3)), 4, mesh, chunk=4, rng="input")
    except ValueError as e:
        res["farm_indivisible"] = str(e)

    # the data axis: four shards, and (2 chains x 2 data) from (0, 0, 1)
    dmesh = tmesh.make_mesh(data=world)
    d = dmesh.get_local_rank(tmesh.AXIS_DATA)
    m = N_DATA // world
    x, y = inp["data_x"], inp["data_y"]
    sh = tpar.ShardedLinReg(x[d * m:(d + 1) * m], y[d * m:(d + 1) * m],
                            n_total=N_DATA, method="xla", mesh=dmesh)
    res["data_logp"] = sh.log_prob_batch(inp["data_theta"])

    def make_local(x_l, y_l):
        t = tpar.ShardedLinReg(x_l, y_l, n_total=N_DATA, mesh=m22)
        return tpmp.make_superstep(t, tpmp.PMPConfig(N=3, depth=2,
                                                     step_size=0.02))

    _, recs = tpar.run_chains_data_sharded(
        make_local, x, y, 4, torch.tensor([[0.0, 0.0, 1.0]] * 2), 800, m22,
        device="cpu")
    res["data_chains"] = recs["samples"]
    try:
        tpar.run_chains_data_sharded(make_local, x[:-1], y[:-1], 4,
                                     torch.zeros((2, 3)), 1, m22,
                                     device="cpu")
    except ValueError as e:
        res["data_indivisible"] = str(e)

    # the tree axis: P = 16 over 4 ranks on pmpx's noise
    tmesh4 = tmesh.make_mesh(tree=world)
    target = BayesLinReg(inp["tree_x"], inp["tree_y"], temper=50.0 / 2048,
                         method="sweep", device="cpu")
    tsup = tpar.make_tree_sharded_superstep(target, _tree_cfg(),
                                            mesh=tmesh4)
    th2, o = tsup(None, torch.tensor([0.0, 0.0, 1.0]),
                  eps=inp["tree_eps"], u=inp["tree_u"])
    res["tree"] = (th2, o["log_accept"])
    try:
        tpar.make_tree_sharded_superstep(
            target, tpmp.PMPConfig(N=2, depth=1, step_size=0.1),
            mesh=tmesh4)
    except ValueError as e:
        res["tree_indivisible"] = str(e)

    # multichain over the world: a sharded run and a sweep cell
    res["mc_run"] = tmc.run(n_data=512, n_chains=world, num_steps=100,
                            sharded=True, out_dir=inp["mc_dir"] + "/run",
                            device="cpu")
    res["mc_sweep"] = tmc.sweep(Ps=(4,), algos=("pmp",), num_steps=120,
                                n_data=2048, out_dir=inp["mc_dir"],
                                device="cpu")
    res["routes"] = tmesh.routes
    torch.save(res, out)
    dist.destroy_process_group()


def _spawn(tmp_path, world, inputs=None):
    """``world`` ranks of :func:`_rank_main` as child processes; returns
    the Popen objects and their result files."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(HERE.parent), str(HERE), os.environ.get("PYTHONPATH", "")]))
    init = tmp_path / f"init_{world}"
    code = ("import sys, test_torch_parallel as t; "
            "t._rank_main(*sys.argv[1:])")
    procs, outs = [], []
    for r in range(world):
        out = tmp_path / f"rank{r}_of_{world}.pt"
        log = open(tmp_path / f"rank{r}_of_{world}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(world), str(init),
             str(inputs), str(out)],
            env=env, stdout=log, stderr=subprocess.STDOUT))
        log.close()
        outs.append(out)
    return procs, outs


def _join(procs, outs, tmp_path, world):
    """Wait for every rank (JOIN_S in all), kill the world on expiry, and
    load each rank's results; fails with the ranks' logs otherwise."""
    try:
        for p in procs:
            p.wait(timeout=JOIN_S)
    except subprocess.TimeoutExpired:
        pass
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    logs = "\n".join((tmp_path / f"rank{r}_of_{world}.log").read_text()
                     for r in range(world))
    assert all(p.returncode == 0 for p in procs), logs
    return [torch.load(o, weights_only=False) for o in outs]


# -- pmpx's side, in this process --------------------------------------


def _pmpx_noise(keys, P, d, steps, step_size):
    """Each chain's per-step (eps, u, pick) as pmpx's run_chain and PMP
    superstep draw them from the chain's key, (C, steps, ...) each."""
    import jax
    import jax.numpy as jnp

    def per_step(kt):
        k_eps, k_draw, k_root, _ = jax.random.split(kt, 4)
        return (step_size * jax.random.normal(k_eps, (P, d), jnp.float32),
                jax.random.uniform(k_draw, (P,), jnp.float32),
                jax.random.randint(k_root, (), 0, P))

    def per_chain(k):
        return jax.vmap(per_step)(jax.random.split(k, steps))

    return tuple(torch.from_numpy(np.array(a))
                 for a in jax.vmap(per_chain)(keys))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """pmpx's references, and the results of the 4-rank world and of the
    process with no world, started together."""
    import jax
    import jax.numpy as jnp
    from pmpx.targets.linreg import make_synthetic_linreg

    tmp = tmp_path_factory.mktemp("worlds")
    ref = {}
    keys = jax.random.split(jax.random.key(0), CHAINS)
    ref["chains_keys"] = keys
    x, y = (np.array(a) for a in make_synthetic_linreg(jax.random.key(1),
                                                         N_DATA))
    theta = jax.random.normal(jax.random.key(2), (16, 3)) * 0.3 + jnp.array(
        [0.0, 0.0, 1.0])
    ref["data"] = (x, y, np.array(theta))
    tx, ty = (np.array(a) for a in make_synthetic_linreg(
        jax.random.key(5), 2048))
    k_eps, k_draw, _, _ = jax.random.split(jax.random.key(6), 4)
    tree_eps = np.array(0.05 * jax.random.normal(k_eps, (16, 3),
                                                    jnp.float32))
    tree_u = np.array(jax.random.uniform(k_draw, (16,), jnp.float32))
    ref["tree"] = (tx, ty, tree_eps, tree_u)
    fx, fy = (np.array(a) for a in make_synthetic_linreg(
        jax.random.key(7), 2048))
    rng = np.random.default_rng(0)
    farm_theta0 = np.concatenate(
        [rng.uniform(-2, 2, (8, 2)), rng.uniform(0.5, 1.5, (8, 1))],
        axis=1).astype(np.float32)
    inputs = {
        "chains_noise": _pmpx_noise(keys, CH_P, 1, T, 1.0),
        "data_x": torch.from_numpy(x), "data_y": torch.from_numpy(y),
        "data_theta": torch.from_numpy(np.array(theta)),
        "tree_x": torch.from_numpy(tx), "tree_y": torch.from_numpy(ty),
        "tree_eps": torch.from_numpy(tree_eps),
        "tree_u": torch.from_numpy(tree_u),
        "farm_x": torch.from_numpy(fx), "farm_y": torch.from_numpy(fy),
        "farm_theta0": torch.from_numpy(farm_theta0),
        "mc_dir": str(tmp / "multichain"),
    }
    ref["inputs"] = inputs
    torch.save(inputs, tmp / "inputs.pt")
    procs, outs = _spawn(tmp, WORLD, tmp / "inputs.pt")
    sprocs, souts = _spawn(tmp, 1)
    ranks = _join(procs, outs, tmp, WORLD)
    (solo,) = _join(sprocs, souts, tmp, 1)
    return ref, ranks, solo, tmp


# -- 20.1 the mesh -----------------------------------------------------


def test_mesh_dims_coordinates_and_pmpx_error(worlds):
    from pmpx.parallel import make_mesh as jmake_mesh
    import jax

    _, ranks, _, _ = worlds
    with pytest.raises(ValueError) as want:
        jmake_mesh(chains=2 * WORLD, devices=jax.devices()[:WORLD])
    for r, res in enumerate(ranks):
        assert res["too_small"] == str(want.value)
        assert res["names"] == ["chains", "data", "tree"]
        # pmpx's reshape of the first ranks to (chains, data, tree)
        assert res["coordinate"] == [r // 2, r % 2, 0]
    assert (tmesh.AXIS_CHAINS, tmesh.AXIS_DATA, tmesh.AXIS_TREE) == (
        "chains", "data", "tree")


def test_rank_outside_the_mesh_gets_none(worlds):
    _, ranks, _, _ = worlds
    assert [res["outside"] for res in ranks] == [
        [0, 0, 0], [1, 0, 0], [2, 0, 0], None]


def test_make_mesh_in_a_process_with_no_world(worlds):
    from pmpx.parallel import make_mesh as jmake_mesh
    import jax

    _, _, solo, _ = worlds
    assert "no CUDA device" in solo["no_card"]  # no fallback to the CPU
    with pytest.raises(ValueError) as want:
        jmake_mesh(chains=2, devices=jax.devices()[:1])
    assert solo["too_small"] == str(want.value)
    assert solo["initialized_before"] is False
    assert (solo["backend"], solo["world"]) == ("gloo", 1)
    assert solo["names"] == ["chains", "data", "tree"]
    assert solo["coordinate"] == [0, 0, 0]


# -- 20.2 the chains axis ----------------------------------------------


def test_sharded_chains_replay_pmpx(worlds):
    """8 chains over 4 ranks on pmpx's per-chain keys: pmpx's selections
    and states (tests/test_parallel.py:28), and bit for bit the port's
    run_chains_vmapped on the same replay, on every rank."""
    import jax
    import jax.numpy as jnp
    from pmpx.parallel import make_mesh as jmake_mesh
    from pmpx.parallel import run_chains_sharded as jrun
    from pmpx.samplers import pmp as jpmp
    from pmpx.targets import Gaussian1D as JGaussian1D

    ref, ranks, _, _ = worlds
    jsup = jpmp.make_superstep(JGaussian1D(), jpmp.PMPConfig(
        N=3, depth=2, step_size=1.0))
    collect = lambda th, o: {"theta": th, **o}  # noqa: E731
    jfinal, jrec = jax.jit(lambda k, t: jrun(
        jsup, k, t, T, jmake_mesh(chains=CHAINS), collect=collect))(
        ref["chains_keys"], jnp.zeros((CHAINS, 1), jnp.float32))
    sup = tpmp.make_superstep(TGaussian1D(), _chains_cfg())
    vfinal, vrec = tpar.run_chains_vmapped(
        _replaying(sup, ref["inputs"]["chains_noise"]), None,
        torch.zeros((CHAINS, 1)), T, collect)
    for res in ranks:
        final, rec = res["chains"]
        assert rec["theta"].shape == (CHAINS, T, 1)
        np.testing.assert_array_equal(rec["root_index"].numpy(),
                                      np.asarray(jrec["root_index"]))
        for k in ("theta", "samples"):
            np.testing.assert_allclose(rec[k].numpy(), np.asarray(jrec[k]),
                                       rtol=0, atol=STATE_ATOL)
        np.testing.assert_allclose(final.numpy(), np.asarray(jfinal),
                                   rtol=0, atol=STATE_ATOL)
        assert torch.equal(final, vfinal)
        for k in vrec:
            assert torch.equal(rec[k], vrec[k]), k
        assert "9 chains do not divide over the 4 ranks" in res[
            "chains_indivisible"]


def test_one_rank_sharded_chains_equal_vmapped_from_the_seed():
    """A mesh of one rank: rank 0's block is every chain, drawing from
    chain_generators(seed, 1)[0]."""
    mesh = tmesh.make_mesh(devices="cpu")
    target = BayesLinReg(*(np.random.default_rng(3).normal(
        size=(2, 512)).astype(np.float32)), temper=0.05, device="cpu")
    sup = tpmp.make_superstep(target, _tree_cfg())
    th0 = torch.tensor([[0.0, 0.0, 1.0]] * 3)
    got = tpar.run_chains_sharded(sup, 11, th0, 12, mesh, device="cpu")
    want = tpar.run_chains_vmapped(
        sup, tpar.chain_generators(11, 1, "cpu")[0], th0, 12)
    assert torch.equal(got[0], want[0])
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k


def test_meshed_farm_equals_the_farm(worlds):
    """The farm over 4 chains-ranks (the plain version, rng="input") bit
    for bit the farm of all 8 chains in this process."""
    ref, ranks, _, _ = worlds
    want = _run_farm(ref["inputs"])
    assert want.shape == (CHAINS, FARM_STEPS, 3)
    for res in ranks:
        assert torch.equal(res["farm"], want)
        assert "10 chains do not divide over the 4 ranks" in res[
            "farm_indivisible"]


def test_multichain_sharded_needs_the_ranks():
    """run(sharded=True) raises pmpx's ValueError where the world has too
    few ranks (pmpx/experiments/multichain.py:79-83)."""
    from pmpx.experiments import multichain as jmc

    import jax

    kw = dict(n_data=256, n_chains=2 * len(jax.devices()), num_steps=10,
              sharded=True)
    with pytest.raises(ValueError, match="need 16 devices") as want:
        jmc.run(out_dir="unused", **kw)
    have = dist.get_world_size() if dist.is_initialized() else 1
    with pytest.raises(ValueError) as got:
        tmc.run(out_dir="unused", device="cpu", **kw)
    assert str(got.value) == str(want.value).replace(
        f"have {len(jax.devices())}", f"have {have}")


def test_multichain_over_the_world_writes_chain_farm(worlds):
    """A sweep(path="sharded") cell over the 4-rank world (its chains
    axis capped at 4 of pmpx's default 8 chains): rank 0 writes
    chain_farm.json, as tests/test_parallel.py:183; every rank returns the
    same table; and run(sharded=True) over 4 ranks."""
    import json

    _, ranks, _, tmp = worlds
    out = ranks[0]["mc_sweep"]
    (row,) = out["rows"]
    assert row["algo"] == "pmp" and row["P"] == 4 and row["chains"] == 8
    assert row["agg_ess_per_s"] > 0
    for c in ("beta0", "beta1", "sigma"):
        assert np.isfinite(row[f"rhat_{c}"])
    assert "over 4 ranks of the chains axis" in out["protocol"]
    saved = json.loads((tmp / "multichain" / "chain_farm.json").read_text())
    assert saved["rows"] == out["rows"]
    for res in ranks[1:]:
        assert [{k: v for k, v in r.items() if k not in (
            "wall_s", "agg_ess_per_s")} for r in res["mc_sweep"]["rows"]] \
            == [{k: v for k, v in row.items() if k not in (
                "wall_s", "agg_ess_per_s")}]
    run = ranks[0]["mc_run"]
    assert all(np.isfinite(v) for v in run.values())
    assert all(res["mc_run"] == run for res in ranks)
    assert (tmp / "multichain" / "run" / "multichain.json").exists()


# -- 20.3 the data axis ------------------------------------------------


def test_data_shards_match_the_sweep_and_pmpx(worlds):
    """Four shards' log-densities (tests/test_parallel.py:47): the port's
    unsharded sweep and pmpx's float64 statistics within rtol 1e-5,
    pmpx's sharded f32 "xla" within 3e-4."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from pmpx.parallel import ShardedLinReg as JSharded
    from pmpx.parallel import make_mesh as jmake_mesh
    from pmpx.targets.linreg import BayesLinReg as JLinReg

    ref, ranks, _, _ = worlds
    x, y, theta = ref["data"]
    sweep = BayesLinReg(x, y, method="sweep", device="cpu").log_prob_batch(
        torch.from_numpy(theta)).numpy()
    suff = np.asarray(JLinReg(x, y, method="suffstats").log_prob_batch(
        theta))
    mesh = jmake_mesh(chains=1, data=WORLD)

    def body(x_l, y_l, th):
        return JSharded(x_l, y_l, n_total=N_DATA,
                        method="xla").log_prob_batch(th)

    xla = np.asarray(jax.jit(shard_map(
        body, mesh=mesh, in_specs=(P("data"), P("data"), P()),
        out_specs=P(), check_vma=False))(x, y, theta))
    for res in ranks:
        got = res["data_logp"].numpy()
        np.testing.assert_allclose(got, sweep, rtol=LOGP_RTOL, atol=0)
        np.testing.assert_allclose(got, suff, rtol=LOGP_RTOL, atol=0)
        np.testing.assert_allclose(got, xla, rtol=XLA_RTOL, atol=0)
        assert np.array_equal(got, ranks[0]["data_logp"].numpy())
        assert "4095 points do not divide over the 2 ranks" in res[
            "data_indivisible"]


def test_data_sharded_chains_recover_the_parameters(worlds):
    """2 chains x 2 data shards, 800 supersteps: the tail's means within
    0.15 of (-1, 2), as tests/test_parallel.py:162 asks; every rank holds
    the same records."""
    _, ranks, _, _ = worlds
    samples = ranks[0]["data_chains"]
    assert samples.shape == (2, 800, 16, 3)
    s = samples.reshape(-1, 3)
    tail = s[len(s) // 2:]
    assert abs(float(tail[:, 0].mean()) + 1.0) < 0.15
    assert abs(float(tail[:, 1].mean()) - 2.0) < 0.15
    for res in ranks[1:]:
        assert torch.equal(res["data_chains"], samples)


# -- 20.4 the tree axis ------------------------------------------------


def test_tree_sharded_superstep_matches_pmpx(worlds):
    """P = 16 over 4 tree ranks on pmpx's noise: log_accept and theta
    within 1e-5 of pmpx's tree-sharded superstep on the same key
    (tests/test_parallel.py:78), pmpx's target on its float64 statistics
    (its f32 "xla" sweep is ~1e-4 off them: ROADMAP §3, "f32 sweep
    accuracy")."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from pmpx import PMPConfig
    from pmpx.parallel import make_mesh as jmake_mesh
    from pmpx.parallel import make_tree_sharded_superstep as jtree
    from pmpx.targets.linreg import BayesLinReg as JLinReg

    ref, ranks, _, _ = worlds
    tx, ty, _, _ = ref["tree"]
    target = JLinReg(tx, ty, temper=50.0 / 2048, method="suffstats")
    sup = jtree(target, PMPConfig(N=1, depth=4, step_size=0.05,
                                  selection="all_first"))

    def body(k, t):
        th2, out = sup(k, t)
        return th2, out["log_accept"]

    th_j, logA_j = jax.jit(shard_map(
        body, mesh=jmake_mesh(chains=1, data=1, tree=WORLD),
        in_specs=(P(), P()), out_specs=(P(), P()), check_vma=False))(
        jax.random.key(6), jnp.array([0.0, 0.0, 1.0], jnp.float32))
    for res in ranks:
        th, logA = res["tree"]
        np.testing.assert_allclose(logA.numpy(), np.asarray(logA_j),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(th.numpy(), np.asarray(th_j),
                                   rtol=1e-5, atol=1e-5)
        assert "the 4 ranks of the 'tree' axis do not divide P = 3" in res[
            "tree_indivisible"]


def test_one_rank_tree_superstep_is_the_plain_superstep():
    """A tree axis of one rank: the plain superstep bit for bit, from
    generators in the same state (the same draws in the same order)."""
    mesh = tmesh.make_mesh(devices="cpu")
    x, y = np.random.default_rng(4).normal(size=(2, 1000)).astype(
        np.float32)
    target = BayesLinReg(x, y, temper=0.05, method="sweep", device="cpu")
    for cfg in (_tree_cfg(), tpmp.PMPConfig(N=3, depth=2, step_size=0.1)):
        a = tpar.make_tree_sharded_superstep(target, cfg, mesh=mesh)
        b = tpmp.make_superstep(target, cfg)
        th = torch.tensor([[0.0, 0.0, 1.0], [0.1, -0.1, 0.8]])
        ga, gb = (tpar.chain_generators(9, 1, "cpu")[0] for _ in "ab")
        for _ in range(3):
            (ta, oa), (tb, ob) = a(ga, th), b(gb, th)
            assert torch.equal(ta, tb)
            for k in ob:
                assert torch.equal(oa[k], ob[k]), k
            th = ta


# -- ROADMAP §3's two faults -------------------------------------------


def test_run_chain_progress_logging_matches_pmpx(capsys):
    """log_every=10 over 30 steps logs steps [0, 10, 20], as pmpx's
    run_chain does on the same call (tests/test_analysis.py:79); the
    default log_fn prints a line a logged step."""
    import jax
    import jax.numpy as jnp
    from pmpx.samplers import mh as jmh
    from pmpx.samplers.base import run_chain as jrun_chain
    from pmpx.targets import Gaussian1D as JGaussian1D
    from pmpx_torch.samplers import mh as tmh

    jseen = []
    jax.jit(lambda k, t: jrun_chain(
        jmh.make_superstep(JGaussian1D(), jmh.MHConfig(step_size=0.5)),
        k, t, 30, log_every=10,
        log_fn=lambda step, st, o: jseen.append(int(step))))(
        jax.random.key(0), jnp.zeros((1,), jnp.float32))
    jax.effects_barrier()
    sup = tmh.make_superstep(TGaussian1D(), tmh.MHConfig(step_size=0.5))
    g = torch.Generator()
    g.manual_seed(0)
    seen = []
    final, trace = run_chain(sup, g, torch.zeros(1), 30,
                             collect=lambda st, o: st, log_every=10,
                             log_fn=lambda step, st, o: seen.append(
                                 (step, st.clone())))
    assert [s for s, _ in seen] == sorted(jseen) == [0, 10, 20]
    for step, st in seen:  # the state after that step
        assert torch.equal(st, trace[step])
    g.manual_seed(0)
    capsys.readouterr()
    again, _ = run_chain(sup, g, torch.zeros(1), 30, log_every=10)
    assert capsys.readouterr().out.splitlines() == [
        f"[pmpx_torch] step {s}" for s in (0, 10, 20)]
    assert torch.equal(again, final)  # logging changes no draw


def test_run_chain_without_logging_reads_nothing_back():
    from torch.profiler import ProfilerActivity, profile

    x, y = np.random.default_rng(1).normal(size=(2, 1000)).astype(np.float32)
    sup = tpmp.make_superstep(BayesLinReg(x, y, temper=0.05, method="sweep",
                                          device="cpu"), _tree_cfg())
    g = torch.Generator()
    g.manual_seed(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_chain(sup, g, torch.tensor([0.0, 0.0, 1.0]), 3, log_every=None)
    names = {e.key for e in prof.key_averages()}
    assert "aten::_local_scalar_dense" not in names
    assert "aten::item" not in names


def test_top_level_names_cover_pmpx():
    import pmpx
    import pmpx.parallel

    assert set(pmpx.__all__) <= set(pmpx_torch.__all__)
    for name in pmpx_torch.__all__:
        assert getattr(pmpx_torch, name) is not None
    assert set(pmpx.parallel.__all__) <= set(tpar.__all__)
    assert pmpx_torch.SamplerSpec is pmpx_torch.config.SamplerSpec
    assert pmpx_torch.MPConfig is pmpx_torch.samplers.mp.MPConfig


def test_import_does_no_cuda_work_and_no_jax():
    code = ("import sys, torch, pmpx_torch, pmpx_torch.parallel; "
            "assert not torch.cuda.is_initialized(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pmpx')]; assert not bad, bad; "
            "import torch.distributed as d; "
            "assert not d.is_initialized()")
    env = dict(os.environ, PYTHONPATH=str(HERE.parent))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=60)


def test_sharded_linreg_needs_its_mesh_and_takes_pmpx_names():
    x = torch.zeros(8)
    with pytest.raises(TypeError, match="mesh"):
        tpar.ShardedLinReg(x, x, 8)
    with pytest.raises(ValueError, match="unknown method"):
        tpar.ShardedLinReg(x, x, 8, method="suffstats",
                           mesh=tmesh.make_mesh(devices="cpu"))
    mesh = tmesh.make_mesh(devices="cpu")
    for name in ("xla", "pallas", "sweep"):
        t = tpar.ShardedLinReg(x, x, 8, method=name, mesh=mesh)
        assert t.method == "sweep" and t.local.device.type == "cpu"


def test_collectives_count_their_route():
    mesh = tmesh.make_mesh(devices="cpu")
    before = {k: dict(v) for k, v in tmesh.routes.items()}
    g = mesh.get_group(tmesh.AXIS_DATA)
    t = torch.arange(4.0)
    assert torch.equal(tmesh.all_reduce_sum(t, g), t * dist.get_world_size(g))
    assert torch.equal(t, torch.arange(4.0))  # left as it was
    assert torch.equal(tmesh.all_gather_cat(t[None], g, dim=0), t[None])
    assert tmesh.routes["all_reduce"]["direct"] == before["all_reduce"][
        "direct"] + 1
    assert tmesh.routes["all_gather"]["direct"] == before["all_gather"][
        "direct"] + 1
    assert tmesh.routes["all_reduce"]["host"] == before["all_reduce"]["host"]


def test_one_rank_meshed_farm_is_the_farm():
    mesh = tmesh.make_mesh(devices="cpu")
    x, y = np.random.default_rng(6).normal(size=(2, 256)).astype(np.float32)
    target = BayesLinReg(x, y, temper=0.1, device="cpu")
    th0 = torch.tensor([[0.0, 0.0, 1.0], [0.5, -0.5, 0.7], [0, 1, 2.0]])
    got, want = (tpar.run_chains_fused(
        target, _farm_cfg(), tpar.chain_generators(2, 3, "cpu"), th0, 20, m,
        chunk=8, rng="input") for m in (mesh, None))
    assert got.shape == (3, 20, 3) and torch.equal(got, want)
