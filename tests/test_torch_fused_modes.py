"""The flat-MP and general (N, depth) modes of the port's fused chain
against pmpx's Pallas megakernel in interpret mode, fed the same injected
uniforms; supports() against pmpx's; the plain version's contract for
each mode."""

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
from pmpx_torch.samplers.pmp import PMPConfig as TCfg  # noqa: E402

# The chains' states: both packages compute Box-Muller and the log-density
# in f32 with their own log/cos, so a state differs by a few ulps per
# superstep; 2 chunks of 8 supersteps stay well within 1e-5.  The MTM
# distances are taken about theta in the port and about 0 in pmpx (ROADMAP
# §3): equal in algebra, a few 1e-5 apart in f32 log weights, which these
# draws never bring to a cdf edge (the same nodes are selected, checked
# through the states).
STATE_ATOL = 1e-5


def _pair(n, temper=0.05):
    x, y = make_synthetic_linreg(jax.random.key(0), n)
    jt = BayesLinReg(x, y, temper=temper, method="fused")
    tt = linreg_from_numpy(np.array(x), np.array(y), temper=temper,
                           method="fused", device="cpu")
    return jt, tt


# tests/test_fused_chain.py's flat and general configs
MODE_CASES = [
    (7, 1, 1000, 3), (31, 1, 300, 4), (199, 1, 2000, 5),
    (3, 2, 1000, 6), (3, 3, 500, 7), (7, 2, 1500, 8), (7, 3, 300, 9),
]


@pytest.mark.parametrize(
    "N,depth,n,seed", MODE_CASES,
    ids=[f"N{c[0]}-D{c[1]}-n{c[2]}" for c in MODE_CASES])
def test_plain_modes_match_pmpx_interpret(N, depth, n, seed):
    jt, tt = _pair(n)
    cfg = JCfg(N=N, depth=depth, step_size=0.05, trans_sigma=0.8,
               selection="all_first")
    chunk, steps = 8, 16  # two chunks: the carry across launches
    run = jfc.make_fused_chain(jt, cfg, chunk=chunk, rng="input",
                               interpret=pltpu.InterpretParams())
    key = jax.random.key(seed)
    theta0 = jnp.array([0.0, 0.0, 1.0], jnp.float32)
    want = np.asarray(run(key, theta0, steps))

    # the uniforms that run drew (tests/test_fused_chain.py's replay)
    P = cfg.P
    L = jfc._lane_extent(P)
    assert L == tfc.lane_extent(P)
    _, k_u = jax.random.split(key)
    uin = 1.0 - np.asarray(
        jax.random.uniform(k_u, (2, chunk * 17, L), jnp.float32))

    tcfg = pmp_config_from_jax(cfg)
    assert tfc.chain_mode(tcfg) == ("mp" if depth == 1 else "general")
    trun = tfc.make_fused_chain(tt, tcfg, chunk=chunk, rng="input")
    name = tfc.KERNEL_NAME[tfc.chain_mode(tcfg)]
    before = launches[name]
    got = trun(None, torch.tensor([0.0, 0.0, 1.0]), steps,
               uin=torch.tensor(uin)).numpy()
    assert launches[name] == before  # CPU: the plain version
    assert got.shape == want.shape == (steps, 3)
    assert len({tuple(r) for r in got}) > 1  # the chain moved
    np.testing.assert_allclose(got, want, rtol=0, atol=STATE_ATOL)


SUPPORT_GRID = [
    (N, depth, stab)
    for N, depth in [(1, 1), (1, 4), (1, 10), (1, 11), (3, 1), (7, 1),
                     (199, 1), (1023, 1), (1024, 1), (3, 2), (3, 3),
                     (3, 5), (7, 2), (7, 3), (15, 2), (31, 2), (2, 2),
                     (5, 2), (2, 6), (6, 3), (3, 6)]
    for stab in ("none", "zscore")
]


@pytest.mark.parametrize("emit", ["root", "all"])
@pytest.mark.parametrize(
    "N,depth,stab", SUPPORT_GRID,
    ids=[f"N{N}-D{d}-{s}" for N, d, s in SUPPORT_GRID])
def test_supports_equals_pmpx(N, depth, stab, emit):
    """Exactly pmpx's answer (its power-of-two-base rule, its 8 MiB
    group-matrix cap and emit="all"'s 512-lane cap included)."""
    jcfg = JCfg(N=N, depth=depth, step_size=0.1, stabilizer=stab)
    tcfg = TCfg(N=N, depth=depth, step_size=0.1, stabilizer=stab)
    assert tfc.supports(tcfg, emit) is jfc.supports(jcfg, emit)


def test_supports_covers_the_time_grid():
    """Every fused cell of the reference's time grid and conv_pmp's
    512-node tree is supported, in the mode pmpx would run it."""
    for N, depth, mode in [(3, 1, "mp"), (1023, 1, "mp"), (1, 2, "binary"),
                           (1, 10, "binary"), (7, 3, "general")]:
        cfg = TCfg(N=N, depth=depth, step_size=0.02)
        assert tfc.supports(cfg)
        assert tfc.chain_mode(cfg) == mode


def test_spec_to_cfg_matches_pmpx():
    from pmpx.config import SamplerSpec as JSpec
    from pmpx_torch.config import SamplerSpec as TSpec

    for kw in (dict(algo="mp", N=1023, depth=3, step_size=0.02),
               dict(algo="pmp", N=7, depth=3, step_size=0.02,
                    trans_sigma=0.5, stabilizer="zscore"),
               dict(algo="pmp", N=1, depth=10, step_size=0.02,
                    selection="all_uniform")):
        j = jfc.spec_to_cfg(JSpec(**kw))
        t = tfc.spec_to_cfg(TSpec(**kw))
        assert t == pmp_config_from_jax(j)
        assert tfc.supports(t) is jfc.supports(j)


def test_trans_norm_zero_means_the_dimension():
    _, tt = _pair(300)
    assert tfc.trans_norm(tt, TCfg(N=3, depth=1, step_size=0.1)) == 1.0
    cfg = TCfg(N=3, depth=1, step_size=0.1, trans_normalize_by=0.0)
    assert tfc.trans_norm(tt, cfg) == 3.0
    cfg = TCfg(N=3, depth=1, step_size=0.1, trans_normalize_by=2.5)
    assert tfc.trans_norm(tt, cfg) == 2.5


@pytest.mark.parametrize("norm", [0.0, 2.0])
def test_trans_normalize_by_reaches_the_walk(norm):
    """pmpx and the port with trans_normalize_by 0 (the dimension) and 2."""
    jt, tt = _pair(800)
    cfg = JCfg(N=7, depth=2, step_size=0.05, trans_sigma=0.3,
               trans_normalize_by=norm, selection="all_first")
    key = jax.random.key(21)
    run = jfc.make_fused_chain(jt, cfg, chunk=8, rng="input",
                               interpret=pltpu.InterpretParams())
    want = np.asarray(run(key, jnp.array([0.0, 0.0, 1.0]), 8))
    _, k_u = jax.random.split(key)
    uin = 1.0 - np.asarray(jax.random.uniform(k_u, (1, 8 * 17, 128)))
    trun = tfc.make_fused_chain(tt, pmp_config_from_jax(cfg), chunk=8,
                                rng="input")
    got = trun(None, torch.tensor([0.0, 0.0, 1.0]), 8,
               uin=torch.tensor(uin)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=STATE_ATOL)


@pytest.mark.parametrize("N,depth", [(3, 1), (199, 1), (3, 2), (7, 3)])
def test_ref_chunks_carry_and_trace_rows(N, depth):
    """Two chunks equal one chunk of twice the length; trace row 3 is the
    selected node, and the state is that node's position."""
    _, tt = _pair(500)
    P, steps = (N + 1) ** depth, 6
    mode = "mp" if depth == 1 else "general"
    g = torch.Generator()
    g.manual_seed(N)
    L = tfc.lane_extent(P)
    uin = 1.0 - torch.rand((2 * steps * tfc.U_ROWS, L), generator=g)
    kw = dict(P=P, depth=depth, n_data=float(tt.n), temper=tt.temper,
              step_size=0.1, mode=mode, N=N, trans_sigma=0.7)
    th0 = torch.tensor([0.0, 0.0, 1.0])
    whole, th_w = tfc.chain_chunk(tt.x2d, tt.y2d, th0, steps=2 * steps,
                                  uin=uin, **kw)
    half = steps * tfc.U_ROWS
    a, th_a = tfc.chain_chunk(tt.x2d, tt.y2d, th0, steps=steps,
                              uin=uin[:half].contiguous(), **kw)
    b, th_b = tfc.chain_chunk(tt.x2d, tt.y2d, th_a, steps=steps,
                              uin=uin[half:].contiguous(), **kw)
    torch.testing.assert_close(torch.cat([a, b], dim=1), whole, rtol=0,
                               atol=0)
    torch.testing.assert_close(th_b, th_w, rtol=0, atol=0)
    assert torch.equal(whole[:3, -1], th_w)
    k = whole[3]
    assert bool(((k >= 0) & (k < P) & (k == k.round())).all())


@pytest.mark.parametrize("N,depth", [(1, 2), (3, 1), (7, 2)])
def test_replay_against_plain_on_the_cpu(N, depth):
    """On the CPU chain_chunk is the plain version, so the replay agrees
    at every superstep with no error, and its trace continues across
    chunks from the state each chunk left."""
    _, tt = _pair(300)
    P, steps, chunks = (N + 1) ** depth, 5, 2
    g = torch.Generator()
    g.manual_seed(depth)
    uin = 1.0 - torch.rand((chunks, steps * tfc.U_ROWS, tfc.lane_extent(P)),
                           generator=g)
    kw = dict(depth=depth, n_data=float(tt.n), temper=tt.temper,
              step_size=0.1, mode=tfc._mode_of(N, depth), N=N,
              trans_sigma=0.7)
    th0 = torch.tensor([0.0, 0.0, 1.0])
    trace, th, agree, err, misses = tfc.replay_against_plain(
        tt.x2d, tt.y2d, th0, uin, P=P, **kw)
    want, th_w = tfc.fused_chain_ref(tt.x2d, tt.y2d, th0,
                                     uin.reshape(-1, uin.shape[2]), P=P, **kw)
    assert (agree, err, misses) == (chunks * steps, 0.0, [])
    torch.testing.assert_close(trace, want, rtol=0, atol=0)
    torch.testing.assert_close(th, th_w, rtol=0, atol=0)


def test_ref_step_weights_are_normalised_per_level():
    """mp: logA is a log-softmax (sums to 1 in probability); general: each
    level's factor normalises every sibling group, so the weights of the
    base**depth leaves of each level-0 path sum to one level by level."""
    _, tt = _pair(400)
    stats = tfc.suff_stats(tt.x2d, tt.y2d)
    g = torch.Generator()
    g.manual_seed(1)
    theta = torch.tensor([-0.9, 1.9, 0.6])
    for N, depth, mode in [(15, 1, "mp"), (3, 2, "general")]:
        P = (N + 1) ** depth
        u1 = 1.0 - torch.rand((3, P), generator=g)
        u2 = 1.0 - torch.rand((3, P), generator=g)
        _, logA, _, _, _, k = tfc.ref_step(
            stats, theta, u1, u2, torch.tensor(0.5), depth=depth,
            n_data=float(tt.n), temper=tt.temper, step_size=0.1, mode=mode,
            N=N, trans_sigma=0.5)
        assert 0 <= int(k) < P
        if mode == "mp":
            assert abs(float(torch.exp(logA).sum()) - 1.0) < 1e-5
        else:
            # level-1 groups are {h + 4j}; the level-0 group is nodes 0..3
            # and node x's level-0 factor is that of x mod 4, so summing
            # exp(logA) over all 16 nodes gives 1
            assert abs(float(torch.exp(logA).sum()) - 1.0) < 1e-5


def test_chain_chunk_refuses_what_no_kernel_takes():
    _, tt = _pair(300)
    th = torch.zeros(3)
    base = dict(n_data=300.0, temper=0.05, step_size=0.1)

    def call(P, depth, mode, N, steps=2):
        L = tfc.lane_extent(P)
        uin = torch.full((steps * tfc.U_ROWS, L), 0.5)
        return tfc.chain_chunk(tt.x2d, tt.y2d, th, steps=steps, uin=uin,
                               P=P, depth=depth, mode=mode, N=N, **base)

    call(200, 1, "mp", 199)
    call(512, 3, "general", 7)
    with pytest.raises(ValueError):  # P is not (N+1)**depth
        call(100, 1, "mp", 199)
    with pytest.raises(ValueError):  # a non-power-of-two base
        call(36, 2, "general", 5)
    with pytest.raises(ValueError):  # a flat config in general mode
        call(8, 1, "general", 7)
    with pytest.raises(ValueError):  # a tree in flat mode
        call(16, 2, "mp", 3)
    with pytest.raises(ValueError):  # beyond 1024 nodes
        call(2048, 1, "mp", 2047)
    with pytest.raises(ValueError):
        call(8, 3, "ternary", 1)
