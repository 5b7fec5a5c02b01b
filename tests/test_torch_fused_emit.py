"""The port's fused chain with ``emit="all"`` (the ESS protocol's per-slot
emission) against pmpx's Pallas megakernel in interpret mode, fed the same
injected uniforms; supports(cfg, "all") against pmpx's; and the chain
farm's plain version against C single chains and, on injected uniforms,
against the plain chain."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pmpx.kernels import fused_chain as jfc  # noqa: E402
from pmpx.samplers.pmp import PMPConfig as JCfg  # noqa: E402
from pmpx.targets.linreg import BayesLinReg, make_synthetic_linreg  # noqa: E402
from pmpx_torch.interop import linreg_from_numpy, pmp_config_from_jax  # noqa: E402
from pmpx_torch.kernels import fused_chain as tfc  # noqa: E402
from pmpx_torch.kernels import launches  # noqa: E402
from pmpx_torch.parallel import chains as tchains  # noqa: E402
from pmpx_torch.samplers.pmp import PMPConfig as TCfg  # noqa: E402

# root, jumps, last and emit_b0 against pmpx's interpret mode: 2e-4, the
# tolerance of pmpx's own emit-all test (tests/test_fused_chain.py).  Both
# compute Box-Muller and the log-density in f32 with their own log/cos
# (a few ulps a superstep), and the MTM distances about theta here and
# about 0 in pmpx (ROADMAP §3); the same slots are drawn, which the
# emit_b0 comparison checks slot by slot.
EMIT_TOL = 2e-4


def _pair(n, temper=0.05):
    x, y = make_synthetic_linreg(jax.random.key(0), n)
    jt = BayesLinReg(x, y, temper=temper, method="fused")
    tt = linreg_from_numpy(np.array(x), np.array(y), temper=temper,
                           method="fused", device="cpu")
    return jt, tt


# binary P in {8, 32}, flat MP P in {8, 128}, general (3, 2)
EMIT_CASES = [(1, 3, 3), (1, 5, 4), (7, 1, 5), (127, 1, 6), (3, 2, 7)]


@pytest.mark.parametrize(
    "N,depth,seed", EMIT_CASES,
    ids=[f"N{c[0]}-D{c[1]}" for c in EMIT_CASES])
def test_plain_emit_all_matches_pmpx_interpret(N, depth, seed):
    jt, tt = _pair(1000)
    cfg = JCfg(N=N, depth=depth, step_size=0.05, trans_sigma=0.8,
               selection="all_first")
    chunk, steps = 8, 16  # two chunks: the carry across launches
    run = jfc.make_fused_chain(jt, cfg, chunk=chunk, rng="input",
                               emit="all", interpret=pltpu.InterpretParams())
    key = jax.random.key(seed)
    theta0 = jnp.array([0.0, 0.0, 1.0], jnp.float32)
    want = {k: np.asarray(v) for k, v in run(key, theta0, steps).items()}

    # the uniforms that run drew (tests/test_fused_chain.py's replay)
    P = cfg.P
    L = tfc.lane_extent(P)
    _, k_u, k_e = jax.random.split(key, 3)
    uin = 1.0 - np.asarray(
        jax.random.uniform(k_u, (2, chunk * 17, L), jnp.float32))
    uemit = 1.0 - np.asarray(
        jax.random.uniform(k_e, (2, chunk, L), jnp.float32))

    tcfg = pmp_config_from_jax(cfg)
    trun = tfc.make_fused_chain(tt, tcfg, chunk=chunk, rng="input",
                                emit="all")
    before = dict(launches)
    got = trun(None, torch.tensor([0.0, 0.0, 1.0]), steps,
               uin=torch.tensor(uin), uemit=torch.tensor(uemit))
    got = {k: v.numpy() for k, v in got.items()}
    assert launches == before  # CPU: the plain version
    assert set(got) == set(want) == {"root", "jumps", "last", "emit_b0"}
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=EMIT_TOL,
                                   atol=EMIT_TOL, err_msg=k)
    assert len({tuple(r) for r in got["root"]}) > 1  # the chain moved
    # slot 0's stream is the chain path (all_first), bit for bit
    np.testing.assert_array_equal(got["emit_b0"][0], got["root"][:, 0])


def test_plain_emit_all_matches_its_own_definition():
    """ref_emit by hand: the count of cdf entries below u*sum(w), the
    states drawn, and the jump sum over slots 0..P-1."""
    g = torch.Generator()
    g.manual_seed(0)
    P = 16
    Y = torch.randn((3, P), generator=g)
    w = torch.rand(P, generator=g)
    w[3] = 0.0  # a zero weight: its edge equals its left neighbour's
    cdf = torch.cumsum(w, 0)
    ue = torch.rand(P + 5, generator=g)  # lanes past P are not read
    k, sel, J = tfc.ref_emit(Y, w, cdf, ue)
    cdf_np, thr = cdf.numpy(), ue[:P].numpy() * w.sum().item()
    want = np.minimum(np.searchsorted(cdf_np, thr, side="left"), P - 1)
    np.testing.assert_array_equal(k.numpy(), want)
    assert 3 not in k.tolist()
    np.testing.assert_array_equal(sel.numpy(), Y.numpy()[:, want])
    d = np.diff(sel.numpy(), axis=1)
    np.testing.assert_allclose(J.item(), (d * d).sum(), rtol=1e-6)


SUPPORT_GRID = [(1, 8), (1, 9), (1, 10), (3, 1), (127, 1), (511, 1),
                (512, 1), (1023, 1), (3, 2), (3, 4), (7, 3), (15, 2),
                (31, 2), (2, 2)]


@pytest.mark.parametrize("stab", ["none", "zscore"])
@pytest.mark.parametrize("N,depth", SUPPORT_GRID,
                         ids=[f"N{N}-D{d}" for N, d in SUPPORT_GRID])
def test_supports_all_equals_pmpx(N, depth, stab):
    """emit="all": pmpx's answer, its cap of a 512-lane extent included."""
    jcfg = JCfg(N=N, depth=depth, step_size=0.1, stabilizer=stab)
    tcfg = TCfg(N=N, depth=depth, step_size=0.1, stabilizer=stab)
    assert tfc.supports(tcfg, "all") is jfc.supports(jcfg, "all")


def test_emit_all_refusals():
    _, tt = _pair(300)
    with pytest.raises(ValueError, match="does not support"):
        tfc.make_fused_chain(tt, TCfg(N=1, depth=10, step_size=0.1),
                             emit="all")
    kw = tfc.chain_consts(tt, TCfg(N=1, depth=3, step_size=0.1))
    uin = torch.rand((2, 4 * tfc.U_ROWS, 128))
    th = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="one chain"):
        tfc.chain_chunk(tt.x2d, tt.y2d, th, steps=4, uin=uin, emit="all",
                        uemit=torch.rand((4, 128)), **kw)
    with pytest.raises(ValueError, match="uemit"):
        tfc.chain_chunk(tt.x2d, tt.y2d, th[0], steps=4, uin=uin[0],
                        emit="all", **kw)
    with pytest.raises(ValueError, match="emit"):
        tfc.chain_chunk(tt.x2d, tt.y2d, th[0], steps=4, uin=uin[0],
                        emit="some", **kw)


@pytest.mark.parametrize("N,depth", [(1, 3), (7, 1), (3, 2)])
def test_replay_emit_against_plain_on_the_cpu(N, depth):
    """The replay helper chip_smoke.py uses: on the CPU the "kernel" is
    the plain version itself, so every slot agrees and the errors are 0."""
    _, tt = _pair(500)
    kw = tfc.chain_consts(tt, TCfg(N=N, depth=depth, step_size=0.05,
                                   trans_sigma=0.8))
    g = torch.Generator()
    g.manual_seed(N + depth)
    L = tfc.lane_extent(kw["P"])
    uin = 1.0 - torch.rand((2, 5 * tfc.U_ROWS, L), generator=g)
    uemit = 1.0 - torch.rand((2, 5, L), generator=g)
    out = tfc.replay_emit_against_plain(
        tt.x2d, tt.y2d, torch.tensor([0.0, 0.0, 1.0]), uin, uemit, **kw)
    assert out["slots"] == 10 * kw["P"] == out["slots_agree"]
    assert out["state_err"] == 0.0 and out["jump_err"] == 0.0
    assert out["b0_root_equal"] and not out["misses"]
    assert out["trace"].shape == (8, 10)
    assert out["emit_b0"].shape == (10, kw["P"])
    assert torch.equal(out["theta"], out["trace"][:3, -1])


@pytest.mark.parametrize("N,depth", [(1, 3), (7, 1)])
def test_farm_plain_equals_single_chains(N, depth):
    """The farm's plain version: chain c of C equals a single chain run
    from its own generator and theta0, bit for bit."""
    _, tt = _pair(400)
    cfg = TCfg(N=N, depth=depth, step_size=0.05, selection="all_first")
    C, steps, chunk = 3, 20, 8  # 3 chunks, the last one cut
    theta0 = torch.tensor([[0.0, 0.0, 1.0], [0.1, 0.2, 0.9],
                           [-0.5, 1.0, 1.2]])
    farm = tchains.make_chain_farm_fused(tt, cfg, steps, chunk=chunk)
    before = dict(launches)
    got = farm(tchains.chain_generators(5, C, "cpu"), theta0)
    assert launches == before  # CPU: the plain version
    assert got.shape == (C, steps, 3)
    single = tfc.make_fused_chain(tt, cfg, chunk=chunk)
    for c, gen in enumerate(tchains.chain_generators(5, C, "cpu")):
        assert torch.equal(got[c], single(gen, theta0[c], steps))
    assert not torch.equal(got[0], got[1])
    again = tchains.run_chains_fused(
        tt, cfg, tchains.chain_generators(5, C, "cpu"), theta0, steps,
        chunk=chunk)
    assert torch.equal(got, again)


@pytest.mark.parametrize("N,depth", [(1, 3), (7, 1), (3, 2)])
def test_farm_injected_uniforms_replay_against_plain(N, depth):
    """The farm runner's rng="input" path: chain c of the runner fed uin
    (n_chunks, C, chunk*17, L) is the plain chain on uin[:, c], bit for
    bit, and replay_roots_against_plain (chip_smoke.py's check of the
    farm cell) finds every selection equal with no error; a state moved
    to another node is flagged as a miss at its step."""
    _, tt = _pair(300)
    cfg = TCfg(N=N, depth=depth, step_size=0.05, selection="all_first")
    kw = tfc.chain_consts(tt, cfg)
    C, steps, chunk = 3, 20, 8  # 3 chunks, the last one cut
    L = tfc.lane_extent(kw["P"])
    g = torch.Generator()
    g.manual_seed(N + depth)
    uin = 1.0 - torch.rand((3, C, chunk * tfc.U_ROWS, L), generator=g)
    theta0 = torch.tensor([[0.0, 0.0, 1.0], [0.1, 0.2, 0.9],
                           [-0.5, 1.0, 1.2]])
    farm = tchains.make_chain_farm_fused(tt, cfg, steps, chunk=chunk,
                                         rng="input")
    got = farm(tchains.chain_generators(0, C, "cpu"), theta0, uin=uin)
    assert got.shape == (C, steps, 3)
    for c in range(C):
        u_c = uin[:, c].reshape(-1, L)
        want, _ = tfc.fused_chain_ref(tt.x2d, tt.y2d, theta0[c], u_c, **kw)
        assert torch.equal(got[c], want[:3, :steps].T)
        u_c = u_c[:steps * tfc.U_ROWS]
        assert tfc.replay_roots_against_plain(
            tt.x2d, tt.y2d, theta0[c], u_c, got[c], **kw) == (steps, 0.0,
                                                               [])
    # chain 0's state at step 5 moved to another node of its superstep
    u0 = uin[:, 0].reshape(-1, L)[:steps * tfc.U_ROWS]
    want0, _ = tfc.fused_chain_ref(tt.x2d, tt.y2d, theta0[0], u0, **kw)
    P, b = kw.pop("P"), 5 * tfc.U_ROWS
    Y5 = tfc.ref_step(tfc.suff_stats(tt.x2d, tt.y2d), got[0, 4],
                      u0[b:b + 3, :P], u0[b + 8:b + 11, :P], u0[b + 16, 0],
                      **kw)[0]
    other = (int(want0[3, 5]) + 1) % P
    roots = got[0].clone()
    roots[5] = Y5[:, other]
    agree, _, misses = tfc.replay_roots_against_plain(
        tt.x2d, tt.y2d, theta0[0], u0, roots, P=P, **kw)
    assert agree < steps and misses[0][:3] == (5, int(want0[3, 5]), other)


def test_farm_refusals():
    _, tt = _pair(300)
    cfg = TCfg(N=1, depth=3, step_size=0.05)
    farm = tchains.make_chain_farm_fused(tt, cfg, 8, chunk=8)
    with pytest.raises(ValueError, match="generators"):
        farm(tchains.chain_generators(0, 2, "cpu"), torch.zeros((3, 3)))
    with pytest.raises(ValueError, match="does not support"):
        tchains.make_chain_farm_fused(
            tt, TCfg(N=1, depth=3, step_size=0.05, stabilizer="zscore"), 8)
