"""The binary superstep's tree kernels (``pmpx_torch/kernels/pmp_tree.py``,
``csrc/pmp_tree.cu``) on the CPU: what the select kernel computes, written
in torch, against the plain versions; the binary-search draw against
``categorical_many``'s count; ``make_superstep`` on the CPU unchanged; the
card path's plumbing through the plain versions; the wrapper's refusals.
The kernels themselves run in ``tests/test_torch_gpu.py`` (marked gpu)."""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pmpx_torch import tree  # noqa: E402
from pmpx_torch.kernels import launches, pmp_tree  # noqa: E402
from pmpx_torch.resample import categorical_many  # noqa: E402
from pmpx_torch.samplers import pmp  # noqa: E402
from pmpx_torch.samplers.base import batch_log_prob  # noqa: E402
from pmpx_torch.samplers.stabilize import stabilize_logits  # noqa: E402
from pmpx_torch.transition import GaussianRW  # noqa: E402

INF = float("inf")
SELECTIONS = ["all_uniform", "all_first", "single"]


def _logpi(depth, C, kind, seed):
    """(C, P) log-densities (C None: one chain, (P,)); ``nonfinite`` puts
    -inf, +inf and NaN among them."""
    P = 1 << depth
    g = torch.Generator().manual_seed(seed)
    lp = 40.0 * torch.randn((C or 1, P), generator=g)
    if kind == "nonfinite":
        lp[0, 1 % P] = -INF
        lp[-1, 3 % P] = INF
        lp[0, 6 % P] = float("nan")
        if P >= 16:
            lp[-1, 8:12] = -INF  # a whole subtree that cannot be chosen
    return lp if C else lp[0]


def _kernel_weights(logpi, depth, stabilizer, nan_guard):
    """What tree_select_kernel computes before its draws, in torch: each
    sibling pair's logsumexp as torch.logsumexp does it, each node's sum
    in level order, the two-pass z-score and the guard."""
    P = 1 << depth
    x = torch.arange(P)
    acc = torch.zeros_like(logpi)
    for i in range(depth):
        half = 1 << i
        h = x & (half - 1)
        a, b = logpi[..., h], logpi[..., h + half]
        m = torch.maximum(a, b)
        m = torch.where(m.abs() == INF, torch.zeros_like(m), m)
        lse = torch.log(torch.exp(a - m) + torch.exp(b - m)) + m
        acc = acc + (logpi[..., x & (2 * half - 1)] - lse)
    w = acc
    if stabilizer == "zscore":
        mean = w.sum(-1, keepdim=True) / P
        sd = torch.sqrt(((w - mean) ** 2).sum(-1, keepdim=True) / P)
        sd = torch.where(sd < 1e-30, torch.full_like(sd, 1e-30), sd)
        w = (w - mean) / sd
    if nan_guard:
        w = torch.where(torch.isnan(w) | (w == INF), torch.zeros_like(w), w)
    return acc, w


@pytest.mark.parametrize("nan_guard", [True, False])
@pytest.mark.parametrize("stabilizer", ["none", "zscore"])
@pytest.mark.parametrize("kind", ["finite", "nonfinite"])
@pytest.mark.parametrize("C", [None, 4])
@pytest.mark.parametrize("depth", range(1, 11))
def test_kernel_weights_equal_log_accept_tree(depth, C, kind, stabilizer,
                                              nan_guard):
    logpi = _logpi(depth, C, kind, seed=depth * 7 + (C or 0))
    Y = torch.zeros((*logpi.shape, 3))
    want = pmp.log_accept_tree(Y, logpi, tree.topology(1, depth),
                               GaussianRW())
    got, got_logits = _kernel_weights(logpi, depth, stabilizer, nan_guard)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6,
                               equal_nan=True)
    torch.testing.assert_close(
        got_logits, stabilize_logits(want, stabilizer, nan_guard),
        rtol=1e-5, atol=1e-5, equal_nan=True)


def _search(cdf, u):
    """The select kernel's draw: the first j with not u > cdf_j, by binary
    search over each row, clipped to P - 1."""
    P = cdf.shape[-1]
    lo = torch.zeros(u.shape, dtype=torch.long)
    hi = torch.full(u.shape, P, dtype=torch.long)
    while bool((lo < hi).any()):
        mid = (lo + hi) // 2
        go = u > torch.take_along_dim(cdf, mid.clamp(max=P - 1), dim=-1)
        active = lo < hi
        lo = torch.where(active & go, mid + 1, lo)
        hi = torch.where(active & ~go, mid, hi)
    return lo.clamp(max=P - 1).to(torch.int32)


def _cdf(logits):
    cdf = torch.cumsum(torch.softmax(logits, dim=-1), dim=-1)
    return cdf / cdf[..., -1:]


@pytest.mark.parametrize("kind", ["normal", "spread", "neg_inf", "all_nan",
                                  "pos_inf", "all_neg_inf"])
@pytest.mark.parametrize("P", [2, 8, 1024])
def test_binary_search_equals_categorical_many(P, kind):
    g = torch.Generator().manual_seed(P)
    logits = torch.randn((3, P), generator=g)
    if kind == "spread":  # most probabilities underflow to 0
        logits = logits * 200.0
    elif kind == "neg_inf":
        logits[:, ::3] = -INF
    elif kind == "all_nan":
        logits[1, P // 2] = float("nan")
    elif kind == "pos_inf":
        logits[2, 0] = INF
    elif kind == "all_neg_inf":
        logits[0] = -INF
    num = 4 * P
    u = torch.rand((3, num), generator=g)
    cdf = _cdf(logits)
    u[:, :P] = torch.where(torch.isnan(cdf), u[:, :P], cdf)  # on the steps
    u[:, P] = 0.0
    want = categorical_many(logits, num, u=u)
    torch.testing.assert_close(_search(cdf, u), want, rtol=0, atol=0)


def _kernel_cdf(p, T, jitter):
    """tree_select_kernel's CDF in float32 for one chain, its per-thread
    starts moved by ``jitter`` ulps each (as a parallel sum may round
    them): every thread's running sum from its start, the exclusive
    maximum of the threads' running sums at positive nodes, then the
    running maximum over positive nodes, over the last entry."""
    P = p.shape[0]
    per = max(1, P // T)
    f = np.float32
    chunks = [p[i:i + per] for i in range(0, P, per)]
    starts, acc = [], f(0)
    for ch, j in zip(chunks, jitter):
        s = acc
        for _ in range(abs(int(j))):
            s = np.nextafter(s, f(np.inf if j > 0 else -np.inf), dtype=f)
        starts.append(max(s, f(0)))
        for v in ch:
            acc = f(acc + v)
    tops = []
    for ch, s in zip(chunks, starts):
        run, top = s, f(0)
        for v in ch:
            run = f(run + v)
            if v > 0:
                top = max(top, run)
        tops.append(top)
    cdf = np.empty(P, dtype=f)
    for t, (ch, s) in enumerate(zip(chunks, starts)):
        cur = max(tops[:t], default=f(0))
        run = s
        for k, v in enumerate(ch):
            run = f(run + v)
            if v > 0:
                cur = max(cur, run)
            cdf[t * per + k] = cur
    return cdf / cdf[-1]


@pytest.mark.parametrize("T", [32, 256, 1024])
def test_kernel_cdf_is_monotone_and_never_draws_zero_weight(T):
    """Whatever the parallel sum's rounding of the threads' starts, the
    kernel's CDF is monotone, gives a zero-probability node no width (so
    the binary search never draws it), and stays within 1e-6 of
    categorical_many's."""
    g = torch.Generator().manual_seed(T)
    P = 1024
    logits = 30.0 * torch.randn(P, generator=g)
    logits[::5] = -INF
    p = torch.softmax(logits, -1).numpy()
    assert (p == 0).sum() > P // 5  # underflow adds zeros to the -inf ones
    jitter = np.random.default_rng(T).integers(-2, 3, size=P // max(1, P // T))
    cdf = _kernel_cdf(p, T, jitter)
    assert np.all(np.diff(cdf) >= 0)
    zero = np.flatnonzero(p == 0)
    prev = np.where(zero > 0, cdf[np.maximum(zero - 1, 0)], 0.0)
    assert np.array_equal(cdf[zero], prev)
    want = _cdf(logits).numpy()
    np.testing.assert_allclose(cdf, want, rtol=0, atol=1e-6)
    u = torch.rand(200_000, generator=g)
    u = torch.cat([u[u > 0], torch.from_numpy(cdf.copy())])
    u = u[u > 0]
    drawn = _search(torch.from_numpy(cdf), u)
    assert not np.isin(drawn.numpy(), zero).any()


class _Quadratic:
    d = 3

    def log_prob_batch(self, Theta):
        return -0.5 * (Theta * Theta).sum(-1) * 40.0


def _torch_superstep(target, cfg, generator, theta):
    """The torch path of make_superstep as it was: the four functions."""
    topo = cfg.topology()
    batch, d = theta.shape[:-1], theta.shape[-1]
    eps = cfg.step_size * torch.randn((*batch, cfg.P, d),
                                      generator=generator, dtype=theta.dtype)
    Y = pmp.tree_positions(theta, eps, topo)
    logpi = batch_log_prob(target, Y.reshape(-1, d)).reshape(*batch, cfg.P)
    logA = pmp.log_accept_tree(Y, logpi, topo, cfg.transition())
    logits = stabilize_logits(logA, cfg.stabilizer, cfg.nan_guard)
    theta2, samples, root = pmp.select_and_emit(cfg, Y, logits, generator)
    return theta2, {"samples": samples, "log_accept": logA,
                    "root_index": root, "root_logp": pmp._take(logpi, root)}


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


def _run_both(cfg, C, seed, superstep):
    shape = (C, 3) if C else (3,)
    g = torch.Generator().manual_seed(1)
    theta = 0.3 * torch.randn(shape, generator=g)
    ga = torch.Generator().manual_seed(seed)
    gb = torch.Generator().manual_seed(seed)
    for _ in range(3):
        want = _torch_superstep(_Quadratic(), cfg, ga, theta)
        got = superstep(gb, theta)
        _same(got[0], want[0])
        for k in want[1]:
            _same(got[1][k], want[1][k])
        assert torch.equal(ga.get_state(), gb.get_state())
        theta = got[0]


@pytest.mark.parametrize("stabilizer", ["none", "zscore"])
@pytest.mark.parametrize("C", [None, 4])
@pytest.mark.parametrize("selection", SELECTIONS)
def test_make_superstep_on_the_cpu_is_the_torch_path(selection, C,
                                                     stabilizer):
    """On the CPU the superstep is bit for bit the four torch functions,
    with the same generator stream, and launches no tree kernel."""
    cfg = pmp.PMPConfig(N=1, depth=5, step_size=0.2, selection=selection,
                        stabilizer=stabilizer)
    before = dict(launches)
    _run_both(cfg, C, 5, pmp.make_superstep(_Quadratic(), cfg))
    assert launches == before


@pytest.mark.parametrize("C", [None, 4])
@pytest.mark.parametrize("selection", SELECTIONS)
def test_card_path_through_the_plain_versions(monkeypatch, selection, C):
    """The card path's draws, reshapes and order of generator calls
    (randn, the target, rand, randint), run here through the wrappers'
    plain versions: bit for bit the torch path."""
    monkeypatch.setattr(pmp_tree, "engages", lambda cfg, theta: True)
    cfg = pmp.PMPConfig(N=1, depth=6, step_size=0.2, selection=selection,
                        stabilizer="zscore")
    _run_both(cfg, C, 9, pmp.make_superstep(_Quadratic(), cfg))


@pytest.mark.parametrize("scale", [1.0, 0.02])
def test_tree_positions_plain_version(scale):
    g = torch.Generator().manual_seed(2)
    theta, eps = torch.randn((4, 3), generator=g), torch.randn(
        (4, 16, 3), generator=g)
    before = launches["pmp_tree_positions"]
    got = pmp_tree.tree_positions(theta, eps, 4, scale)
    assert launches["pmp_tree_positions"] == before
    _same(got, pmp.tree_positions(theta, scale * eps, tree.topology(1, 4)))


@pytest.mark.parametrize("N,depth,dtype,cuda,want", [
    (1, 10, torch.float32, True, True),
    (1, pmp_tree.MAX_DEPTH, torch.float32, True, True),
    (1, pmp_tree.MAX_DEPTH + 1, torch.float32, True, False),
    (3, 2, torch.float32, True, False),
    (1, 10, torch.float64, True, False),
    (1, 10, torch.float32, False, False),
])
def test_engages_only_binary_float32_on_a_card(N, depth, dtype, cuda, want):
    theta = SimpleNamespace(is_cuda=cuda, dtype=dtype)
    assert pmp_tree.engages(pmp.PMPConfig(N, depth, 0.1), theta) is want


def _select_args(C=2, depth=3, d=3, selection="all_uniform"):
    P = 1 << depth
    cfg = pmp.PMPConfig(N=1, depth=depth, step_size=0.1, selection=selection)
    num = 1 if selection == "single" else P
    return cfg, dict(Y=torch.zeros((C, P, d)), logpi=torch.zeros((C, P)),
                     u=torch.rand((C, num)),
                     pick=torch.zeros(C, dtype=torch.int64))


BAD_SELECT = {
    "Y float64": lambda a: a.update(Y=a["Y"].double()),
    "logpi bfloat16": lambda a: a.update(logpi=a["logpi"].bfloat16()),
    "logpi of another P": lambda a: a.update(logpi=torch.zeros((2, 4))),
    "u of one draw for all_uniform": lambda a: a.update(u=torch.rand((2, 1))),
    "u float64": lambda a: a.update(u=a["u"].double()),
    "pick int32": lambda a: a.update(pick=a["pick"].int()),
    "pick missing": lambda a: a.update(pick=None),
    "pick of another C": lambda a: a.update(
        pick=torch.zeros(3, dtype=torch.int64)),
    "Y not contiguous": lambda a: a.update(
        Y=torch.zeros((2, 3, 8)).transpose(1, 2)),
    "Y of two axes": lambda a: a.update(Y=torch.zeros((8, 3))),
}


@pytest.mark.parametrize("case", sorted(BAD_SELECT))
def test_tree_select_raises_on_bad_input(case):
    cfg, args = _select_args()
    BAD_SELECT[case](args)
    with pytest.raises((TypeError, ValueError)):
        pmp_tree.tree_select(cfg, **args)


@pytest.mark.parametrize("case", ["general tree", "too deep"])
def test_tree_select_raises_outside_its_trees(case):
    cfg, args = _select_args()
    if case == "general tree":
        cfg = pmp.PMPConfig(N=3, depth=2, step_size=0.1)
        args["logpi"] = torch.zeros((2, 16))
    else:
        cfg = pmp.PMPConfig(N=1, depth=pmp_tree.MAX_DEPTH + 1, step_size=0.1)
    with pytest.raises(ValueError):
        pmp_tree.tree_select(cfg, **args)


BAD_POSITIONS = {
    "theta float64": (torch.zeros((2, 3), dtype=torch.float64),
                      torch.zeros((2, 8, 3)), 3),
    "eps float16": (torch.zeros((2, 3)),
                    torch.zeros((2, 8, 3), dtype=torch.float16), 3),
    "eps of another P": (torch.zeros((2, 3)), torch.zeros((2, 4, 3)), 3),
    "eps of another d": (torch.zeros((2, 3)), torch.zeros((2, 8, 2)), 3),
    "theta of one axis": (torch.zeros(3), torch.zeros((8, 3)), 3),
    "depth 0": (torch.zeros((2, 3)), torch.zeros((2, 1, 3)), 0),
    "depth above the kernel's": (torch.zeros((1, 1)),
                                 torch.zeros((1, 1 << 15, 1)), 15),
}


@pytest.mark.parametrize("case", sorted(BAD_POSITIONS))
def test_tree_positions_raises_on_bad_input(case):
    theta, eps, depth = BAD_POSITIONS[case]
    with pytest.raises((TypeError, ValueError)):
        pmp_tree.tree_positions(theta, eps, depth)


def test_tree_select_plain_version_single_emits_its_root():
    cfg, args = _select_args(selection="single")
    args["Y"] = torch.randn(args["Y"].shape)
    theta2, samples, root, logA, root_logp = pmp_tree.tree_select(cfg, **args)
    assert samples.shape == (2, 1, 3) and root.dtype == torch.int32
    _same(samples[:, 0], theta2)
    _same(theta2, args["Y"][torch.arange(2), root.long()])
