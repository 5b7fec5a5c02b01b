"""The chain kernel's walks (pmpx_torch/csrc/fused_chain.cu), emulated in
float32 on the CPU: the general walk that forms each sibling group's sums,
totals and logs once (one thread per group, all levels in one pass)
against the per-member walk it replaced, bit for bit, and against
ref_step's vectorised walk; the weights the flat-MP walk hands over
against the plain version's; and the stamped library's build and
labels."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pmpx_torch import _build  # noqa: E402
from pmpx_torch.interop import linreg_from_numpy  # noqa: E402
from pmpx_torch.kernels import fused_chain as tfc  # noqa: E402

CU = Path(tfc.__file__).resolve().parents[1] / "csrc" / "fused_chain.cu"

# (N, depth) of the general mode: a power-of-two base N + 1 >= 4, depth >= 2,
# P = (N + 1)**depth <= 1024 (N = 1 is binary, depth 1 flat MP)
GENERAL_TREES = [(3, 2), (3, 3), (3, 4), (3, 5), (7, 2), (7, 3), (15, 2),
                 (31, 2)]

F32 = torch.float32


def _seq_sum(cols):
    """A left-to-right float32 sum of equal-shape tensors."""
    acc = torch.zeros_like(cols[0])
    for c in cols:
        acc = acc + c
    return acc


def _sums_of(S, members):
    """G (3 tensors) and Q of the groups whose members are ``members``
    (list over j of index tensors), summed over j in order, as the kernel
    does: g += s; q += s0 s0 + s1 s1 + s2 s2."""
    g0 = g1 = g2 = q = None
    for b in members:
        s0, s1, s2 = S[0, b], S[1, b], S[2, b]
        if g0 is None:
            g0 = g1 = g2 = q = torch.zeros_like(s0)
        g0 = g0 + s0
        g1 = g1 + s1
        g2 = g2 + s2
        q = q + (s0 * s0 + s1 * s1 + s2 * s2)
    return g0, g1, g2, q


def _lw(S_x, sq_x, g0, g1, g2, q, logpi_x, base, denom):
    cross = S_x[0] * g0 + S_x[1] * g1 + S_x[2] * g2
    gd2 = torch.tensor(float(base), dtype=F32) * sq_x - 2.0 * cross + q
    return logpi_x - gd2 / denom


def walk_per_member(S, logpi, base, depth, denom, P):
    """The per-member general walk (the kernel's earlier form): at every
    level each node x < m forms its group's sums over the base members
    itself, the level max zm, e = exp(lw - zm), and each valid node forms
    its group's total T, clamps it at 1e-30 and adds lw - zm - log T."""
    x = torch.arange(P)
    sq = S[0] * S[0] + S[1] * S[1] + S[2] * S[2]
    logA = torch.zeros(P, dtype=F32)
    for i in range(depth):
        temp = base**i
        m = temp * base
        xm = x[:m]
        h = xm & (temp - 1)
        g0, g1, g2, q = _sums_of(S, [h + j * temp for j in range(base)])
        lw = _lw(S[:, :m], sq[:m], g0, g1, g2, q, logpi[:m], base, denom)
        zm = lw.max()
        e = torch.exp(lw - zm)
        hx = x & (temp - 1)
        T = _seq_sum([e[hx + j * temp] for j in range(base)])
        T = torch.clamp(T, min=1e-30)
        logA = logA + lw[x & (m - 1)] - zm - torch.log(T)
    return logA


def group_slot(x, lb, depth):
    """csrc/fused_chain.cu's group_slot: thread x's (level, residue)."""
    g, temp, i = x, 1, 0
    while i < depth and g >= temp:
        g -= temp
        temp <<= lb
        i += 1
    return i, g


def walk_group_once(S, logpi, base, depth, denom, P, L=None):
    """The group-once general walk (csrc/fused_chain.cu GeneralWalk), its
    shared arrays and indices as the kernel lays them out: group slot g
    holds level gl's residue gh; the lw and e rows of level i start at
    base * goff_i in one flat array; log T overwrites G in slot g."""
    lb = base.bit_length() - 1
    L = L or max(P, 128)
    x = torch.arange(L)
    valid = x < P
    S = torch.cat([S, torch.zeros((3, L - P), dtype=F32)], 1) if L > P else S
    logpi = (torch.cat([logpi, torch.zeros(L - P, dtype=F32)])
             if L > P else logpi)
    slots = [group_slot(t, lb, depth) for t in range(L)]
    grp = torch.full((4, 341), float("nan"), dtype=F32)
    rows = torch.full((2 * 1364,), float("nan"), dtype=F32)
    # 2. one thread per group slot: G_h and Q_h over its base members
    for t, (gl, gh) in enumerate(slots):
        if gl < depth:
            gtemp = 1 << (lb * gl)
            g = _sums_of(S, [torch.tensor([gh + j * gtemp])
                             for j in range(base)])
            for r in range(4):
                grp[r, t] = g[r][0]
    # 3. every node's lw per level into the rows; the level maxima
    sq = S[0] * S[0] + S[1] * S[1] + S[2] * S[2]
    temp, goff = 1, 0
    zm = []
    for i in range(depth):
        m = temp << lb
        xm = x[:m]
        gi = goff + (xm & (temp - 1))
        lw = _lw(S[:, :m], sq[:m], grp[0, gi], grp[1, gi], grp[2, gi],
                 grp[3, gi], logpi[:m], base, denom)
        rows[(goff << lb) + xm] = lw
        zm.append(lw.max())
        goff += temp
        temp = m
    # 4. the e rows
    temp, goff = 1, 0
    for i in range(depth):
        m = temp << lb
        at = (goff << lb) + x[:m]
        rows[1364 + at] = torch.exp(rows[at] - zm[i])
        goff += temp
        temp = m
    # 5. one thread per group slot: T_h and log T_h
    for t, (gl, gh) in enumerate(slots):
        if gl < depth:
            gtemp = 1 << (lb * gl)
            e = rows[1364 + ((t - gh) << lb):]
            T = _seq_sum([e[gh + j * gtemp:gh + j * gtemp + 1]
                          for j in range(base)])
            grp[0, t] = torch.log(torch.clamp(T, min=1e-30))[0]
    # every valid node sums its depth terms in level order
    logA = torch.zeros(L, dtype=F32)
    temp, goff = 1, 0
    for i in range(depth):
        m = temp << lb
        logA = (logA + rows[(goff << lb) + (x & (m - 1))] - zm[i]
                - grp[0, goff + (x & (temp - 1))])
        goff += temp
        temp = m
    return torch.where(valid, logA, torch.zeros_like(logA))[:P]


def _adversarial(N, depth, seed):
    """S and logpi that meet the walk's edges: spreads from 1e-3 to past
    where exp underflows (lw - zm < -104), ties (equal logpi and S), and a
    level-1 group whose every member lies ~500 below the level max, so its
    total underflows to 0 and is clamped at 1e-30."""
    base = N + 1
    P = base**depth
    rng = np.random.default_rng(seed)
    scale = rng.choice([1e-3, 1.0, 30.0, 150.0], size=P)
    logpi = (rng.standard_normal(P) * scale - 1e3).astype(np.float32)
    S = (rng.standard_normal((3, P)) * 0.05).astype(np.float32)
    S[:, 0] = 0.0  # the root's offset
    logpi[base + 2] = logpi[base + 1]  # a tie
    S[:, base + 2] = S[:, base + 1]
    hot = np.arange(P) % base == 1  # level 1's group of residue 1
    logpi[hot] -= 500.0
    logpi[0] = -1e3 + 200.0  # the level-0 and level-1 max, far above
    return torch.tensor(S), torch.tensor(logpi)


@pytest.mark.parametrize("N,depth", GENERAL_TREES)
def test_group_once_general_walk_is_bit_equal_to_the_per_member_walk(
        N, depth):
    """The group-once walk's logA is the per-member walk's bit for bit on
    adversarial inputs: exp underflow, ties, a clamped group total; and
    those edges are met."""
    base, P = N + 1, (N + 1) ** depth
    S, logpi = _adversarial(N, depth, seed=10 * N + depth)
    denom = torch.tensor(2.0 * 0.8 * 0.8 * 3.0, dtype=F32)
    got = walk_group_once(S, logpi, base, depth, denom, P)
    want = walk_per_member(S, logpi, base, depth, denom, P)
    assert got.dtype == want.dtype == F32
    assert bool(torch.isfinite(want).all())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the edges: a level-1 group total below the clamp, exp underflow
    temp, m = base, base * base
    x = torch.arange(m)
    sq = S[0] * S[0] + S[1] * S[1] + S[2] * S[2]
    g = _sums_of(S, [(x & (temp - 1)) + j * temp for j in range(base)])
    lw = _lw(S[:, :m], sq[:m], *g, logpi[:m], base, denom)
    e = torch.exp(lw - lw.max())
    assert float(e[x % base == 1].sum()) < 1e-30
    assert int((e == 0).sum()) >= base


@pytest.mark.parametrize("N,depth", [t for t in GENERAL_TREES
                                     if (t[0] + 1) ** t[1] < 128])
def test_group_once_general_walk_with_lanes_above_p(N, depth):
    """Lanes past P (the block is P rounded up to 128) hold no group and
    change nothing: the walk on 128 lanes equals the walk on P."""
    base, P = N + 1, (N + 1) ** depth
    S, logpi = _adversarial(N, depth, seed=depth)
    denom = torch.tensor(1.0, dtype=F32)
    a = walk_group_once(S, logpi, base, depth, denom, P, L=128)
    b = walk_per_member(S, logpi, base, depth, denom, P)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _ref_inputs(N, depth, seed, step):
    """ref_step's S and log-densities, operation for operation, from numpy
    uniforms on a small linreg target, and ref_step's own logA."""
    rng = np.random.default_rng(seed)
    n = 500
    xs = rng.uniform(-1, 1, n).astype(np.float32)
    ys = (-1.0 + 2.0 * xs + 0.5 * rng.standard_normal(n)).astype(np.float32)
    t = linreg_from_numpy(xs, ys, temper=1.0, method="fused", device="cpu")
    base, P = N + 1, (N + 1) ** depth
    u = torch.tensor(1.0 - rng.random((7, P), dtype=np.float32))
    stats = tfc.suff_stats(t.x2d, t.y2d)
    theta = torch.tensor([0.0, 0.0, 1.0])
    kw = dict(depth=depth, n_data=float(t.n), temper=1.0, step_size=step,
              mode="general", N=N, trans_sigma=0.8, trans_norm=3.0)
    Y, logA, *_ = tfc.ref_step(stats, theta, u[:3], u[3:6], u[6, 0], **kw)
    z = torch.sqrt(-2.0 * torch.log(u[:3])) * torch.cos(
        (2.0 * np.pi) * u[3:6])
    eps = step * z
    node = torch.arange(P)
    S = torch.zeros_like(eps)
    for i in range(depth):
        temp = base**i
        born = ((node // temp) % base) != 0
        S = S + torch.where(born, eps[:, node % (temp * base)],
                            torch.zeros_like(eps))
    assert torch.equal(theta[:, None] + S, Y)
    b0, b1, sg = Y
    sx, sy, sxx, syy, sxy = stats
    rss = (syy + kw["n_data"] * b0 * b0 + b1 * b1 * sxx
           + 2.0 * b0 * b1 * sx - 2.0 * b0 * sy - 2.0 * b1 * sxy)
    s2 = torch.clamp(sg * sg, min=1e-30)
    lp = 1.0 * (-0.5 * kw["n_data"] * (tfc._LOG_2PI + torch.log(s2))
                - rss / (2.0 * s2))
    denom = 2.0 * 0.8 * 0.8 * 3.0
    return S, lp, denom, logA


@pytest.mark.parametrize("N,depth", GENERAL_TREES)
@pytest.mark.parametrize("step", [0.05, 0.5])
def test_group_once_general_walk_matches_ref_step(N, depth, step):
    """On ref_step's own offsets and log-densities (numpy uniforms; a wide
    step puts some group totals near underflow), the group-once walk is
    within 1e-6 (relative, and absolute near 0) of ref_step's vectorised
    general walk, which sums in another order."""
    S, lp, denom, want = _ref_inputs(N, depth, seed=N + depth, step=step)
    base, P = N + 1, (N + 1) ** depth
    got = walk_group_once(S, lp, base, depth, torch.tensor(denom, dtype=F32),
                          P)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _mp_handed(lw, valid):
    """What the flat-MP walk hands the loop: w = exp(fl(lw - m)), m = max
    lw over the valid lanes, 0 at the other lanes."""
    m = lw[valid].max()
    return torch.where(valid, torch.exp(lw - m), torch.zeros_like(lw))


def _mp_plain(lw, valid):
    """The plain version's weights (ref_step's mp walk, then
    exp(logA - max logA)) over the valid lanes."""
    lv = lw[valid]
    m = lv.max()
    logA = lv - (m + torch.log(torch.exp(lv - m).sum()))
    w = torch.zeros_like(lw)
    w[valid] = torch.exp(logA - logA.max())
    return w


def _draws(w, u):
    """k = min(#{x : cdf[x] < u sum(w)}, P - 1) for each uniform u."""
    cdf = torch.cumsum(w, 0)
    return torch.clamp((cdf[None, :] < (u * w.sum())[:, None]).sum(1),
                       max=w.numel() - 1)


def _mp_cases():
    rng = np.random.default_rng(7)
    out = []
    for P in (4, 8, 200, 512, 1024):
        out.append(rng.standard_normal(P) * rng.choice([1e-3, 1.0, 30.0]))
    for P in (8, 1024):
        v = rng.standard_normal(P) * 60.0 - 3e3  # exp underflow, large |lw|
        v[3] = v[5] = v.max()  # a tie at the max
        out.append(v)
        w = rng.standard_normal(P) * 3.0
        w[P // 2:] = -np.inf  # lanes that carry no weight
        out.append(w)
        out.append(np.full(P, -1e30))  # all equal, far from 0
        out.append(-1e3 + np.arange(P) * 1e-4)  # steps near an ulp of lw
    return [np.asarray(v, np.float32) for v in out]


@pytest.mark.parametrize("case", range(len(_mp_cases())))
def test_mp_handed_weights_are_exp_of_lw_minus_max(case):
    """The weights the flat-MP walk hands over, on random and adversarial
    float32 lw (spreads past underflow, ties, -inf lanes, large |lw|,
    ulp-scale steps), over the valid lanes of P and of P rounded up to
    128: 1 at the max, 0 at -inf lanes and lanes >= P, and within the
    rounding of their argument and of exp (2^-24 |lw - m| + 2^-22,
    relative) of float64's exp(lw - m)."""
    lw = torch.tensor(_mp_cases()[case])
    P = lw.numel()
    for L in {P, max(128, P)}:
        lwL = torch.cat([lw, torch.full((L - P,), 5.0)])
        valid = torch.arange(L) < P
        w = _mp_handed(lwL, valid)
        assert bool((w[~valid] == 0).all())
        assert bool(((w >= 0) & (w <= 1)).all())
        assert float(w[valid].max()) == 1.0
        assert bool((w[valid][torch.isinf(lw)] == 0).all())
        lw64 = lw.double()
        d = lw64 - lw64[torch.isfinite(lw64)].max()
        exact = torch.exp(d)
        got = w[valid].double()
        normal = exact >= 1e-37
        bound = exact * (2.0**-24 * d.abs() + 2.0**-22)
        assert bool(((got - exact).abs() <= bound)[normal].all())
        assert bool((got[~normal] <= 2e-37).all())


@pytest.mark.parametrize("case", range(len(_mp_cases())))
def test_mp_handed_weights_draw_as_the_plain_version(case):
    """Over 10,000 uniforms, the draws from the handed weights equal the
    plain version's in at least 99% (chip_smoke.py's gate on the card):
    the two weights differ only by the roundings of logA's constant
    shift."""
    lw = torch.tensor(_mp_cases()[case])
    valid = torch.ones(lw.numel(), dtype=torch.bool)
    rng = np.random.default_rng(case)
    u = torch.tensor(1.0 - rng.random(10_000, dtype=np.float32))
    a = _draws(_mp_handed(lw, valid), u)
    b = _draws(_mp_plain(lw, valid), u)
    assert int((a == b).sum()) >= 9_900


@pytest.mark.parametrize("N", [7, 199, 1023])
@pytest.mark.parametrize("step", [0.05, 0.5])
def test_mp_handed_weights_match_ref_step(N, step):
    """On ref_step's own mp walk (numpy uniforms, its S and lw recomputed
    operation for operation), the handed weights are within the plain
    version's roundings of logA's shift (2^-22 max|lw| + 2^-21, relative)
    of ref_step's w, and pick ref_step's node."""
    rng = np.random.default_rng(N)
    n = 500
    xs = rng.uniform(-1, 1, n).astype(np.float32)
    ys = (-1.0 + 2.0 * xs + 0.5 * rng.standard_normal(n)).astype(np.float32)
    t = linreg_from_numpy(xs, ys, temper=1.0, method="fused", device="cpu")
    P = N + 1
    u = torch.tensor(1.0 - rng.random((7, P), dtype=np.float32))
    stats = tfc.suff_stats(t.x2d, t.y2d)
    theta = torch.tensor([0.0, 0.0, 1.0])
    kw = dict(depth=1, n_data=float(t.n), temper=1.0, step_size=step,
              mode="mp", N=N, trans_sigma=0.8, trans_norm=3.0)
    Y, _, w_ref, _, _, k_ref = tfc.ref_step(stats, theta, u[:3], u[3:6],
                                            u[6, 0], **kw)
    eps = step * (torch.sqrt(-2.0 * torch.log(u[:3]))
                  * torch.cos((2.0 * np.pi) * u[3:6]))
    S = torch.where(torch.arange(P) != 0, eps, torch.zeros_like(eps))
    assert torch.equal(theta[:, None] + S, Y)
    b0, b1, sg = Y
    sx, sy, sxx, syy, sxy = stats
    rss = (syy + kw["n_data"] * b0 * b0 + b1 * b1 * sxx
           + 2.0 * b0 * b1 * sx - 2.0 * b0 * sy - 2.0 * b1 * sxy)
    s2 = torch.clamp(sg * sg, min=1e-30)
    lp = -0.5 * kw["n_data"] * (tfc._LOG_2PI + torch.log(s2)) - rss / (2 * s2)
    sq = (S * S).sum(0)
    d2 = P * sq - 2.0 * (S * S.sum(1)[:, None]).sum(0) + sq.sum()
    lw = lp - d2 / (2.0 * 0.8 * 0.8 * 3.0)
    w = _mp_handed(lw, torch.ones(P, dtype=torch.bool))
    rtol = 2.0**-22 * float(lw.abs().max()) + 2.0**-21
    torch.testing.assert_close(w, w_ref, rtol=rtol, atol=1e-30)
    assert int(_draws(w, u[6, :1])[0]) == int(k_ref)


def test_group_slot_covers_every_group_once():
    """group_slot's slots cover each (level, residue) of every general tree
    exactly once, in level order, within the block and kMaxGroups; the
    rows fit kMaxRows; and the source's constants are what the largest
    tree needs and fit S's shared array twice."""
    src = CU.read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (kMaxDepth|kMaxGroups|kMaxRows|kMaxL) = (\d+);", src)}
    need_groups = need_rows = need_depth = 0
    for N, depth in GENERAL_TREES:
        base, P = N + 1, (N + 1) ** depth
        lb = base.bit_length() - 1
        L = max(P, 128)
        seen = [group_slot(t, lb, depth) for t in range(L)]
        groups = [s for s in seen if s[0] < depth]
        want = [(i, h) for i in range(depth) for h in range(base**i)]
        assert groups == want
        assert all(s[0] == depth for s in seen[len(groups):])
        need_groups = max(need_groups, len(groups))
        need_rows = max(need_rows, sum(base ** (i + 1) for i in range(depth)))
        need_depth = max(need_depth, depth)
    assert consts["kMaxGroups"] == need_groups == 341
    assert consts["kMaxRows"] == need_rows == 1364
    assert consts["kMaxDepth"] == need_depth == 5
    assert 2 * consts["kMaxRows"] <= 3 * consts["kMaxL"]


def test_stamp_phases_follow_the_kernel_enum():
    """STAMP_PHASES names csrc/fused_chain.cu's ChainPhase in order."""
    body = re.search(r"enum ChainPhase \{(.*?)\};", CU.read_text(), re.S)
    names = [n.strip() for n in body.group(1).split(",") if n.strip()]
    assert names[-1] == "kPhases"
    snake = [re.sub(r"(?<!^)([A-Z])", r"_\1", n[1:]).lower()
             for n in names[:-1]]
    assert tuple(snake) == tfc.STAMP_PHASES


@pytest.mark.parametrize("mode,n_walk", [("binary", 3), ("mp", 2),
                                         ("general", 6)])
def test_stamp_split_labels(mode, n_walk):
    """stamp_split divides by the supersteps and names the mode's walk
    phases; it leaves out the walk slots past them that hold no clocks
    and keeps, under the slot's name, one that does."""
    buf = torch.arange(1, len(tfc.STAMP_PHASES) + 1, dtype=torch.int64) * 10
    walk_slots = [i for i, n in enumerate(tfc.STAMP_PHASES)
                  if n.startswith("walk")]
    buf[walk_slots[n_walk:]] = 0
    split = tfc.stamp_split(mode, buf, 10)
    walk = [k for k in split if k.startswith("walk: ")]
    assert len(walk) == n_walk
    assert len(split) == len(tfc.STAMP_PHASES) - 6 + n_walk
    assert split["philox"] == 1.0 and split["trace"] == 15.0
    assert split[walk[0]] == 5.0
    if n_walk < 6:
        buf[walk_slots[-1]] = 70
        assert tfc.stamp_split(mode, buf, 10)["walk5"] == 7.0


def test_stamped_library_build_is_separate():
    """The stamped library compiles only the chain source with the define,
    which is in its hash; the default library's flags never hold it."""
    assert "-DPMPX_CHAIN_STAMPS" in _build._flags(True)
    assert not any("STAMPS" in f for f in _build._flags(False))
    assert [p.name for p in _build._sources(True)
            if p.suffix == ".cu"] == ["fused_chain.cu"]
    assert len([p for p in _build._sources(False) if p.suffix == ".cu"]) >= 3
    assert _build._digest(True) != _build._digest(False)


def test_stamps_need_a_cuda_tensor():
    """chain_chunk refuses a stamps buffer on the CPU (the plain version
    has no phase clocks); without one the CPU path is the plain version."""
    x = torch.linspace(-1, 1, 256).reshape(2, 128)
    y = 2.0 * x - 1.0
    th = torch.tensor([0.0, 0.0, 1.0])
    kw = dict(steps=2, P=16, depth=2, n_data=256.0, temper=1.0,
              step_size=0.05, mode="general", N=3,
              uin=1.0 - torch.rand((2 * tfc.U_ROWS, 128)))
    with pytest.raises(ValueError, match="stamps"):
        tfc.chain_chunk(x, y, th, stamps=torch.zeros(
            len(tfc.STAMP_PHASES), dtype=torch.int64), **kw)
    tr, _ = tfc.chain_chunk(x, y, th, **kw)
    assert tr.shape == (4, 2)


def test_ptxas_usage_names_every_chain_kernel():
    """chip_smoke.py's phase 1 reads each chain kernel's registers and
    shared memory from ptxas's report, with the general kernel's depth
    where it is a template argument, and the SSD scan's per dtype, and
    skips the other kernels."""
    import importlib
    import sys

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    cs = importlib.import_module("chip_smoke")
    fn = "ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__1_cu_c5"
    log = "\n".join([
        fn + "19chain_binary_kernelILb0EEEvNS_9ChainArgsEi' for 'sm_90a'",
        "ptxas info    : Used 32 registers, used 1 barriers, 25492 bytes smem",
        fn + "20chain_general_kernelILb1ELi3EEEvNS_9ChainArgsEiif' for 'x'",
        "ptxas info    : Used 51 registers, used 1 barriers, 32 bytes "
        "cumulative stack size, 45800 bytes smem",
        fn + "20chain_general_kernelILb0EEEvNS_9ChainArgsEiiif' for 'x'",
        "ptxas info    : Used 32 registers, 33820 bytes smem",
        fn + "17lstm_fused_kernelIfEEvv' for 'sm_90a'",
        "ptxas info    : Used 248 registers, used 1 barriers",
        fn + "17mamba2_ssd_kernelIfEEvPKT_PKfS5_S3_S3_S5_PS1_iiNS_7StridesE'"
        " for 'sm_90a'",
        "ptxas info    : Used 128 registers, used 1 barriers, 24960 bytes smem",
        fn + "17mamba2_ssd_kernelI13__nv_bfloat16EEvPKT_PKfS6_S4_S4_S6_PS2_ii"
        "NS_7StridesE' for 'sm_90a'",
        "ptxas info    : Used 127 registers, used 1 barriers, 24960 bytes smem",
    ])
    assert cs.ptxas_usage(log) == {
        "chain_binary_kernel<false>": {"registers": 32, "smem_bytes": 25492},
        "chain_general_kernel<false>": {"registers": 32, "smem_bytes": 33820},
        "chain_general_kernel<true, 3>": {"registers": 51,
                                          "smem_bytes": 45800},
        "mamba2_ssd_kernel<float>": {"registers": 128, "smem_bytes": 24960},
        "mamba2_ssd_kernel<bf16>": {"registers": 127, "smem_bytes": 24960},
    }
