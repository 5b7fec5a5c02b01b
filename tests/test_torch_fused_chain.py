"""The fused chain of pmpx_torch against pmpx's Pallas megakernel in
interpret mode, fed the same injected uniforms (the replay of
tests/test_fused_chain.py), plus the plain version's own contract."""

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


def _pair(n=1000, temper=0.05):
    x, y = make_synthetic_linreg(jax.random.key(0), n)
    jt = BayesLinReg(x, y, temper=temper, method="fused")
    tt = linreg_from_numpy(np.array(x), np.array(y), temper=temper,
                           method="fused", device="cpu")
    return jt, tt


@pytest.mark.parametrize("depth,seed", [(3, 3), (4, 5)])
def test_fused_chain_matches_pmpx_interpret(depth, seed):
    jt, tt = _pair()
    cfg = JCfg(N=1, depth=depth, step_size=0.05, selection="all_first")
    chunk, steps = 16, 32  # two chunks: the carry across launches
    run = jfc.make_fused_chain(jt, cfg, chunk=chunk, rng="input",
                               interpret=pltpu.InterpretParams())
    key = jax.random.key(seed)
    theta0 = jnp.array([0.0, 0.0, 1.0], jnp.float32)
    want = np.asarray(run(key, theta0, steps))

    # the uniforms that run drew (tests/test_fused_chain.py's replay)
    n_chunks = -(-steps // chunk)
    _, k_u = jax.random.split(key)
    L = jfc._lane_extent(2**depth)
    assert L == tfc.lane_extent(2**depth)
    uin = 1.0 - np.asarray(
        jax.random.uniform(k_u, (n_chunks, chunk * 17, L), jnp.float32))

    trun = tfc.make_fused_chain(tt, pmp_config_from_jax(cfg), chunk=chunk,
                                rng="input")
    before = launches["fused_chain"]
    got = trun(None, torch.tensor([0.0, 0.0, 1.0]), steps,
               uin=torch.tensor(uin)).numpy()
    assert launches["fused_chain"] == before  # CPU: the plain version
    assert got.shape == want.shape == (steps, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_ref_chunks_carry_and_trace_rows():
    """Two chunks equal one chunk of twice the length; trace row 3 is the
    selected node, and the state is that node's position."""
    _, tt = _pair(n=500)
    P, depth, steps = 8, 3, 12
    g = torch.Generator()
    g.manual_seed(0)
    L = tfc.lane_extent(P)
    uin = 1.0 - torch.rand((2 * steps * tfc.U_ROWS, L), generator=g)
    kw = dict(P=P, depth=depth, n_data=float(tt.n), temper=tt.temper,
              step_size=0.1)
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


def test_fused_chain_checks_its_inputs():
    _, tt = _pair(n=300)
    kw = dict(P=8, depth=3, n_data=300.0, temper=0.05, step_size=0.1)
    th = torch.zeros(3)
    L = tfc.lane_extent(8)
    good = torch.full((4 * tfc.U_ROWS, L), 0.5)
    with pytest.raises(ValueError):  # not a binary tree
        tfc.chain_chunk(tt.x2d, tt.y2d, th, steps=4, uin=good,
                        **(kw | dict(P=12)))
    with pytest.raises(ValueError):  # wrong uniform rows
        tfc.chain_chunk(tt.x2d, tt.y2d, th, steps=5, uin=good, **kw)
    with pytest.raises(TypeError):
        tfc.chain_chunk(tt.x2d.double(), tt.y2d, th, steps=4, uin=good,
                        **kw)
    with pytest.raises(ValueError):  # rng="kernel" needs a seed
        tfc.chain_chunk(tt.x2d, tt.y2d, th, steps=4, **kw)
    with pytest.raises(ValueError):  # no in-kernel generator on the CPU
        tfc.chain_chunk(tt.x2d, tt.y2d, th, steps=4,
                        seed=torch.zeros(1, dtype=torch.int32), **kw)


def test_kernel_rng_on_cpu_draws_from_the_generator():
    """Off the card rng="kernel" draws input uniforms from the generator
    (as pmpx does off the TPU): reproducible from its seed."""
    _, tt = _pair(n=400)
    cfg = pmp_config_from_jax(
        JCfg(N=1, depth=3, step_size=0.1, selection="all_first"))
    run = tfc.make_fused_chain(tt, cfg, chunk=8, rng="kernel")
    outs = []
    for _ in range(2):
        g = torch.Generator()
        g.manual_seed(7)
        outs.append(run(g, torch.tensor([0.0, 0.0, 1.0]), 20))
    assert outs[0].shape == (20, 3)
    assert torch.equal(outs[0], outs[1])
    assert bool(torch.isfinite(outs[0]).all())


# The binary walk as csrc/fused_chain.cu computes it, in torch f32.  torch's
# CPU kernels may round exp or log1p of the same value differently in their
# vectorised loop and their scalar tail, so the transcendentals run on
# tensors padded to whole vectors, where every element takes one path.
def _padded(fn, v):
    n = v.numel()
    return fn(torch.cat([v, v.new_zeros((-n) % 64)]))[:n]


def _softplus_tail(d):
    """log1pf(expf(-|d|)), the value a sibling pair shares."""
    return _padded(lambda v: torch.log1p(torch.exp(-v.abs())), d)


def _log_sigmoid(d, sp):
    """The kernel's log_sigmoid(d, sp) = -(fmaxf(-d, 0) + sp)."""
    return -(torch.clamp(-d, min=0.0) + sp)


def _walk_per_node(lp, depth):
    """The per-node walk: every node evaluates its own softplus of
    d = lp[a_i] - lp[a_i ^ 2^i] at every level i and sums the terms in
    level order from 0."""
    node = torch.arange(lp.numel())
    logA = torch.zeros_like(lp)
    for i in range(depth):
        anc = node & ((2 << i) - 1)
        d = lp[anc] - lp[anc ^ (1 << i)]
        logA = logA + _log_sigmoid(d, _softplus_tail(d))
    return logA


def _walk_pairs(lp, depth):
    """The pair-shared walk: one softplus per sibling pair (a, a + 2^i),
    both siblings' terms in a row of 2^(i+1) per level, and every node
    summing its row entries in level order from 0."""
    node = torch.arange(lp.numel())
    logA = torch.zeros_like(lp)
    for i in range(depth):
        lo = torch.arange(1 << i)
        d = lp[lo] - lp[lo + (1 << i)]
        sp = _softplus_tail(d)
        row = torch.cat([_log_sigmoid(d, sp), _log_sigmoid(-d, sp)])
        logA = logA + row[node & ((2 << i) - 1)]
    return logA


def _walk_logsigmoid(lp, depth):
    """ref_step's binary walk, torch.nn.functional.logsigmoid per level."""
    node = torch.arange(lp.numel())
    logA = torch.zeros_like(lp)
    for i in range(depth):
        anc = node & (2 ** (i + 1) - 1)
        logA = logA + torch.nn.functional.logsigmoid(
            lp[anc] - lp[anc ^ (2**i)])
    return logA


@pytest.mark.parametrize("depth", range(1, 11))
def test_pair_shared_walk_is_bit_equal_to_the_per_node_walk(depth):
    """One softplus per sibling pair gives the per-node walk's logA bit for
    bit, over differences from ties to far past where expf underflows
    (|d| > 104: exp gives 0; 88-104: subnormal), and both stay within
    1e-6 (relative, and absolute near 0) of ref_step's logsigmoid walk."""
    P = 2**depth
    rng = np.random.default_rng(100 + depth)
    scale = rng.choice([1e-3, 1.0, 30.0, 150.0], size=P)
    lp = (rng.standard_normal(P) * scale - 1e3).astype(np.float32)
    lp[:4] = np.array([0.0, -120.0, -3.0, 92.0], np.float32)[:P]  # |d| 120, 95
    if P >= 8:
        lp[5] = lp[4]  # a tie, d = 0
    lp = torch.tensor(lp)
    d0 = (lp[: P // 2] - lp[P // 2:]).abs()
    assert float(d0.max()) > 104.0 or depth == 1
    got = _walk_pairs(lp, depth)
    want = _walk_per_node(lp, depth)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    ref = _walk_logsigmoid(lp, depth)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(want, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("depth", [3, 10])
def test_pair_shared_walk_matches_ref_step(depth):
    """On ref_step's own log-densities (from numpy uniforms, a wide step so
    that the siblings' differences reach past 100), the pair-shared walk
    is within 1e-6 of the logA ref_step returns."""
    _, tt = _pair(n=500)
    P = 2**depth
    rng = np.random.default_rng(depth)
    u = torch.tensor(1.0 - rng.random((7, P), dtype=np.float32))
    stats = tfc.suff_stats(tt.x2d, tt.y2d)
    kw = dict(depth=depth, n_data=float(tt.n), temper=1.0, step_size=0.5)
    theta = torch.tensor([0.0, 0.0, 1.0])
    Y, logA, *_ = tfc.ref_step(stats, theta, u[:3], u[3:6], u[6, 0], **kw)
    # ref_step's log-density of the positions Y, operation for operation
    b0, b1, sg = Y
    sx, sy, sxx, syy, sxy = stats
    rss = (syy + kw["n_data"] * b0 * b0 + b1 * b1 * sxx
           + 2.0 * b0 * b1 * sx - 2.0 * b0 * sy - 2.0 * b1 * sxy)
    s2 = torch.clamp(sg * sg, min=1e-30)
    lp = 1.0 * (-0.5 * kw["n_data"] * (tfc._LOG_2PI + torch.log(s2))
                - rss / (2.0 * s2))
    assert torch.equal(_walk_logsigmoid(lp, depth), logA)
    assert float((lp[: P // 2] - lp[P // 2:]).abs().max()) > 100.0
    torch.testing.assert_close(_walk_pairs(lp, depth), logA, rtol=1e-6,
                               atol=1e-6)


def _chip_smoke():
    import importlib
    import pathlib
    import sys

    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize(
    "mode,emit,P,N,depth,rng,chains,steps,pipe,calls,mufu", [
        # Philox calls a superstep (2 a node, 3 with the slot uniform, 1
        # usel) and multi-function results (11 a node and the walk's)
        ("binary", "root", 1024, 1, 10, "kernel", 1, 1000, "imad", 2049,
         11 * 1024 + 2 * 1023),
        ("binary", "all", 512, 1, 9, "kernel", 1, 1000, "imad", 1537,
         11 * 512 + 2 * 511),
        ("mp", "root", 1024, 1023, 1, "kernel", 1, 1000, "imad", 2049,
         11 * 1024),
        ("general", "all", 512, 7, 3, "kernel", 1, 1000, "imad", 1537,
         11 * 512 + (8 + 1) + (64 + 8) + (512 + 64)),
        ("binary", "root", 1024, 1, 10, "input", 1, 1000, "mufu", 0,
         11 * 1024 + 2 * 1023),
        ("binary", "root", 512, 1, 9, "kernel", 133, 1000, "imad", 1025,
         11 * 512 + 2 * 511),
        # one superstep of P = 2: reading the data once takes longest
        ("binary", "root", 2, 1, 1, "kernel", 1, 1, "bytes", 5, 22 + 2),
    ])
def test_chain_sm_bound_counts(mode, emit, P, N, depth, rng, chains, steps,
                               pipe, calls, mufu):
    """chip_smoke.py's floor of a chain launch: the counts its docstring
    states, the issue terms at one SM's rates in ceil(C / 132) waves for a
    farm of C chains, the bytes (the data's 2 n floats once, each chain's
    states and per-superstep traffic) at the whole card's memory rate; the
    largest term is the bound."""
    cs = _chip_smoke()
    n = 100_000
    b = cs.chain_sm_bound(mode, emit, P, steps, n, N=N, depth=depth,
                          rng=rng, chains=chains)
    clock = 1.98e9
    waves = -(-chains // 132)
    floats = (8 + P if emit == "all" else 4)
    if rng == "input":
        floats += (7 if emit == "all" else 6) * P + 1
    want = {
        "imad": waves * steps * calls * 40 / 64 / clock * 1e3,
        "mufu": waves * steps * mufu / 16 / clock * 1e3,
        "bytes": 4 * (2 * n + chains * (7 + steps * floats)) / 3.35e12 * 1e3,
    }
    assert b["ms"] == pytest.approx(want)
    assert b["bound_by"] == pipe
    assert b["bound_ms"] == pytest.approx(max(want.values()))
    assert max(want, key=want.get) == pipe
