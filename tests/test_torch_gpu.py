"""The CUDA kernels against their plain versions on a card.  Marked
``gpu``; each test skips when there is no CUDA device (decided in the
test, never at import).  Run on a machine with a card (``--noconftest``
because tests/conftest.py sets up JAX, which that machine need not have;
this file imports neither JAX nor pmpx):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pmpx_torch.kernels import fused_chain as fc  # noqa: E402
from pmpx_torch.kernels import launches  # noqa: E402
from pmpx_torch.kernels.linreg import (  # noqa: E402
    batched_rss, batched_rss_ref, kernel_info, pad_proposals,
)
from pmpx_torch.samplers.pmp import PMPConfig  # noqa: E402
from pmpx_torch.targets.linreg import (  # noqa: E402
    BayesLinReg, make_synthetic_linreg, pad_to_grid,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# linreg_rss: chip_smoke.py's RSS_SHAPES (the shapes the sweep paths give
# the kernel) and two more
RSS_SHAPES = [(1024, 100_000), (1024, 500), (4, 100_000), (4, 500),
              (200, 100_000), (8, 5000), (512, 100_000), (8, 100_000),
              (200, 20_000), (64, 300)]


def _rss_inputs(device, P, n, seed):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x, y = make_synthetic_linreg(g, n)
    x2d, y2d = pad_to_grid(x), pad_to_grid(y)
    b0, b1, _ = pad_proposals(torch.randn(P, generator=g, device=device),
                              torch.randn(P, generator=g, device=device))
    return b0, b1, x2d, y2d


def _rss_bound(b0, b1, x2d, y2d, n_valid):
    """The magnitude of the sum's terms, sum_i (|y| + |b0| + |b1 x|)^2: a
    bound on what f32 rounding can move; within a small factor of the
    rss itself when the sum has many terms."""
    return batched_rss_ref(-b0.abs(), b1.abs(), -x2d.abs(), y2d.abs(),
                           n_valid=n_valid)


@pytest.mark.gpu
@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("P,n", RSS_SHAPES)
def test_linreg_rss_kernel_matches_plain(cuda, P, n, valid):
    b0, b1, x2d, y2d = _rss_inputs(cuda, P, n, P)
    kw = {"n_valid": n} if valid else {}
    before = launches["linreg_rss"]
    got = batched_rss(b0, b1, x2d, y2d, **kw)
    assert launches["linreg_rss"] == before + 1
    want = batched_rss_ref(b0, b1, x2d, y2d, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    again = batched_rss(b0, b1, x2d, y2d, **kw)
    assert torch.equal(got, again)  # no atomics: bit for bit


@pytest.mark.gpu
@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("n", [1, 127, 500, 16_384, 100_000, 250_000])
@pytest.mark.parametrize("P", [8, 16, 64, 128, 576, 1024, 1088, 2048])
def test_linreg_rss_geometry_edges(cuda, P, n, valid):
    """The cluster sizes the launch picks (1 over few points or at P >= 576,
    up to 8 at small P over many points), several waves above P = 1056,
    and the tails: rtol 1e-5 for every sum of many terms; a single point
    (n = 1), where y - b0 - b1 x can cancel and the kernel's FMA rounds
    otherwise than the plain version, within 1e-5 of its terms'
    magnitude."""
    b0, b1, x2d, y2d = _rss_inputs(cuda, P, n, 1000 + P + n)
    kw = {"n_valid": n} if valid else {}
    got = batched_rss(b0, b1, x2d, y2d, **kw)
    want = batched_rss_ref(b0, b1, x2d, y2d, **kw)
    err = (got - want).abs()
    assert bool((err <= 1e-5 * _rss_bound(b0, b1, x2d, y2d, kw.get(
        "n_valid"))).all())
    if not valid or n > 1:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("P,n", [(1024, 100_000), (8, 100_000), (576, 127),
                                 (2048, 250_000)])
def test_linreg_rss_repeats_bit_for_bit(cuda, P, n, valid):
    b0, b1, x2d, y2d = _rss_inputs(cuda, P, n, 7)
    kw = {"n_valid": n} if valid else {}
    first = batched_rss(b0, b1, x2d, y2d, **kw)
    for _ in range(4):
        assert torch.equal(batched_rss(b0, b1, x2d, y2d, **kw), first)


@pytest.mark.gpu
@pytest.mark.parametrize("P,n", [(1024, 100_000), (8, 500)])
def test_linreg_rss_is_one_kernel(cuda, P, n):
    """One CUDA kernel a call, and it is the port's own (torch.profiler)."""
    from pmpx_torch.bench import profile_path

    b0, b1, x2d, y2d = _rss_inputs(cuda, P, n, 3)
    batched_rss(b0, b1, x2d, y2d, n_valid=n)
    prof = profile_path(lambda: batched_rss(b0, b1, x2d, y2d, n_valid=n))
    assert prof["kernels"] == 1
    assert [k.split("<")[0] for k in prof["own"]] == ["rss_kernel"]


@pytest.mark.gpu
@pytest.mark.parametrize("P,n", [(1024, 100_000), (512, 100_000), (8, 500),
                                 (2048, 250_000)])
@pytest.mark.parametrize("valid", [False, True])
def test_linreg_rss_graph_holds_one_kernel(cuda, P, n, valid):
    """A CUDA graph of one call holds one node, a kernel node, with
    n_valid on and off, in one wave and (P = 2048) in several."""
    from pmpx_torch.bench import graph_nodes

    b0, b1, x2d, y2d = _rss_inputs(cuda, P, n, 3)
    kw = {"n_valid": n} if valid else {}
    assert graph_nodes(lambda: batched_rss(b0, b1, x2d, y2d, **kw)) == {
        "kernels": 1, "other": 0}


@pytest.mark.gpu
def test_linreg_rss_geometry_fills_the_card(cuda):
    """At the sweep's shapes every block is resident at once, one per SM,
    on at least 128 SMs."""
    for P in (1024, 512):
        info = kernel_info(P, 100_000)
        assert info["blocks_per_sm"] == 1
        assert info["clusters"] <= info["max_clusters"]
        assert 128 <= info["clusters"] * info["cluster_size"] <= info["sms"]
        assert 1 <= info["cluster_size"] <= 8


@pytest.mark.gpu
def test_linreg_rss_cuda_graph_replays(cuda):
    """A CUDA graph of the call replays to the eager result, and to the
    new result after its inputs change in place."""
    b0, b1, x2d, y2d = _rss_inputs(cuda, 1024, 100_000, 5)
    eager = batched_rss(b0, b1, x2d, y2d, n_valid=100_000)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        batched_rss(b0, b1, x2d, y2d, n_valid=100_000)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = batched_rss(b0, b1, x2d, y2d, n_valid=100_000)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    b0.add_(0.5)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, batched_rss(b0, b1, x2d, y2d, n_valid=100_000))


@pytest.mark.gpu
@pytest.mark.parametrize("depth", range(1, 11))  # 1-6: lanes above P
def test_fused_chain_kernel_matches_plain(cuda, depth):
    g = torch.Generator(device=cuda)
    g.manual_seed(depth)
    x, y = make_synthetic_linreg(g, 3000)
    t = BayesLinReg(x, y, temper=0.05, method="fused", device=cuda)
    P, steps = 2**depth, 40
    uin = 1.0 - torch.rand((steps * fc.U_ROWS, fc.lane_extent(P)),
                           generator=g, device=cuda)
    kw = dict(P=P, depth=depth, n_data=float(t.n), temper=t.temper,
              step_size=0.05)
    th = torch.tensor([0.0, 0.0, 1.0], device=cuda)
    got, th_k = fc.chain_chunk(t.x2d, t.y2d, th, steps=steps, uin=uin, **kw)
    want, th_r = fc.fused_chain_ref(t.x2d, t.y2d, th, uin, **kw)
    # the same nodes (row 3) and states; a draw within an ulp of a cdf
    # edge could pick a neighbour, which these inputs do not meet
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    torch.testing.assert_close(th_k, th_r, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_fused_chain_kernel_rng_is_seeded(cuda):
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    x, y = make_synthetic_linreg(g, 2000)
    t = BayesLinReg(x, y, temper=0.05, method="fused", device=cuda)
    kw = dict(P=16, depth=4, n_data=float(t.n), temper=t.temper,
              step_size=0.05)
    th = torch.tensor([0.0, 0.0, 1.0], device=cuda)
    s1 = torch.tensor([5], dtype=torch.int32, device=cuda)
    s2 = torch.tensor([6], dtype=torch.int32, device=cuda)
    a, _ = fc.chain_chunk(t.x2d, t.y2d, th, steps=50, seed=s1, **kw)
    b, _ = fc.chain_chunk(t.x2d, t.y2d, th, steps=50, seed=s1, **kw)
    c, _ = fc.chain_chunk(t.x2d, t.y2d, th, steps=50, seed=s2, **kw)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert bool(torch.isfinite(a).all())


# (N, depth) of the flat-MP and general modes: the time grid's P = 4 and
# P = 1024 flat cells, P = 200 (lanes above P), and general trees up to
# conv_pmp's N = 7 x depth 3, a base of 32, and depths 4 and 5 (the
# general kernel's instantiations are per depth)
NEW_MODES = [(3, 1), (199, 1), (1023, 1), (3, 2), (7, 3), (31, 2), (3, 4),
             (3, 5)]


def _new_mode_kw(t, N, depth):
    return dict(P=(N + 1) ** depth, depth=depth, n_data=float(t.n),
                temper=t.temper, step_size=0.05,
                mode="mp" if depth == 1 else "general", N=N,
                trans_sigma=0.8)


@pytest.mark.gpu
@pytest.mark.parametrize("N,depth", NEW_MODES)
def test_fused_chain_new_modes_match_plain(cuda, N, depth):
    """The mp and general kernels against their plain versions with
    injected uniforms, step by step from the kernel's own state
    (fc.replay_against_plain, as chip_smoke.py's phase 3b): >= 99% of the
    selections equal and the states within 1e-4 where they are."""
    g = torch.Generator(device=cuda)
    g.manual_seed(N * 10 + depth)
    x, y = make_synthetic_linreg(g, 20_000)
    t = BayesLinReg(x, y, temper=0.01, method="fused", device=cuda)
    kw = _new_mode_kw(t, N, depth)
    steps, chunks = 30, 2
    uin = 1.0 - torch.rand(
        (chunks, steps * fc.U_ROWS, fc.lane_extent(kw["P"])), generator=g,
        device=cuda)
    th = torch.tensor([0.0, 0.0, 1.0], device=cuda)
    name = fc.KERNEL_NAME[kw["mode"]]
    before = launches[name]
    got, th_k, agree, err, _ = fc.replay_against_plain(
        t.x2d, t.y2d, th, uin, **kw)
    assert launches[name] == before + chunks
    assert torch.equal(got[:3, -1], th_k.cpu())
    assert agree >= 0.99 * steps * chunks
    assert err <= 1e-4
    assert len(set(got[3].tolist())) > 1  # the chain moved


@pytest.mark.gpu
@pytest.mark.parametrize("N,depth", [(1023, 1), (7, 3)])
def test_fused_chain_new_modes_kernel_rng_is_seeded(cuda, N, depth):
    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    x, y = make_synthetic_linreg(g, 5000)
    t = BayesLinReg(x, y, temper=0.01, method="fused", device=cuda)
    kw = _new_mode_kw(t, N, depth)
    th = torch.tensor([0.0, 0.0, 1.0], device=cuda)
    s1 = torch.tensor([5], dtype=torch.int32, device=cuda)
    s2 = torch.tensor([6], dtype=torch.int32, device=cuda)
    a, _ = fc.chain_chunk(t.x2d, t.y2d, th, steps=50, seed=s1, **kw)
    b, _ = fc.chain_chunk(t.x2d, t.y2d, th, steps=50, seed=s1, **kw)
    c, _ = fc.chain_chunk(t.x2d, t.y2d, th, steps=50, seed=s2, **kw)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert bool(torch.isfinite(a).all())


# emit="all": binary P = 2, 8, 32 and 512, flat MP P = 8 and 512
# (N = P - 1), general (3, 2) and (7, 3); all within the 512-lane cap
EMIT_MODES = [(1, 1), (1, 3), (1, 5), (1, 9), (7, 1), (511, 1), (3, 2),
              (7, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("N,depth", EMIT_MODES)
def test_fused_chain_emit_all_matches_plain(cuda, N, depth):
    """The emit="all" kernels against their plain versions with injected
    uniforms, step by step from the kernel's own state
    (fc.replay_emit_against_plain, as chip_smoke.py's phase 3d): >= 99%
    of the slot draws equal; the state and the last slot's within 1e-4
    where their draws agree; the jump sum within 1e-4 of max(1, J) where
    every slot agrees; slot 0's b0 bit-equal to the state's."""
    g = torch.Generator(device=cuda)
    g.manual_seed(N * 10 + depth)
    x, y = make_synthetic_linreg(g, 20_000)
    t = BayesLinReg(x, y, temper=0.01, method="fused", device=cuda)
    kw = fc.chain_consts(t, PMPConfig(N=N, depth=depth, step_size=0.05,
                                      trans_sigma=0.8))
    steps, chunks = 30, 2
    L = fc.lane_extent(kw["P"])
    uin = 1.0 - torch.rand((chunks, steps * fc.U_ROWS, L), generator=g,
                           device=cuda)
    uemit = 1.0 - torch.rand((chunks, steps, L), generator=g, device=cuda)
    th = torch.tensor([0.0, 0.0, 1.0], device=cuda)
    name = fc.KERNEL_NAME_ALL[kw["mode"]]
    before = launches[name]
    out = fc.replay_emit_against_plain(t.x2d, t.y2d, th, uin, uemit, **kw)
    assert launches[name] == before + chunks
    assert out["slots_agree"] >= 0.99 * out["slots"]
    assert out["state_err"] <= 1e-4
    assert out["jump_err"] <= 1e-4
    assert out["b0_root_equal"]
    assert torch.equal(out["trace"][:3, -1], out["theta"].cpu())
    assert len(set(out["trace"][0].tolist())) > 1  # the chain moved


@pytest.mark.gpu
@pytest.mark.parametrize("emit", ["root", "all"])
@pytest.mark.parametrize("N,depth", [(1, 9), (511, 1), (7, 3)])
def test_fused_chain_second_launch_is_bit_equal(cuda, N, depth, emit):
    """Each mode's kernel, launched twice on the same injected uniforms
    and state, returns the same trace, state and emitted b0 bit for bit
    (fixed-order reductions, no atomics)."""
    g = torch.Generator(device=cuda)
    g.manual_seed(N + depth)
    x, y = make_synthetic_linreg(g, 20_000)
    t = BayesLinReg(x, y, temper=0.01, method="fused", device=cuda)
    kw = fc.chain_consts(t, PMPConfig(N=N, depth=depth, step_size=0.05,
                                      trans_sigma=0.8))
    steps, L = 60, fc.lane_extent(kw["P"])
    uin = 1.0 - torch.rand((steps * fc.U_ROWS, L), generator=g, device=cuda)
    extra = {}
    if emit == "all":
        extra = dict(emit="all", uemit=1.0 - torch.rand(
            (steps, L), generator=g, device=cuda))
    th = torch.tensor([0.0, 0.0, 1.0], device=cuda)
    first = fc.chain_chunk(t.x2d, t.y2d, th, steps=steps, uin=uin, **kw,
                           **extra)
    second = fc.chain_chunk(t.x2d, t.y2d, th, steps=steps, uin=uin, **kw,
                            **extra)
    assert len(first) == (3 if emit == "all" else 2)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert len(set(first[0][0].tolist())) > 1  # the chain moved


@pytest.mark.gpu
@pytest.mark.parametrize("emit", ["root", "all"])
@pytest.mark.parametrize("rng", ["input", "kernel"])
@pytest.mark.parametrize("N,depth", [(511, 1), (7, 3), (3, 4)])
def test_fused_chain_stamped_library_is_bit_equal(cuda, N, depth, rng, emit):
    """A mp and a general chunk run twice through the default library and
    once through the stamped one (phase clocks): the traces, states and
    emitted b0 are bit-equal, so the stamps change nothing they measure;
    the phases that every superstep runs have clocks, and emit="root" has
    no jump sum."""
    g = torch.Generator(device=cuda)
    g.manual_seed(N + depth)
    x, y = make_synthetic_linreg(g, 20_000)
    t = BayesLinReg(x, y, temper=0.01, method="fused", device=cuda)
    kw = fc.chain_consts(t, PMPConfig(N=N, depth=depth, step_size=0.05,
                                      trans_sigma=0.8))
    steps, L = 60, fc.lane_extent(kw["P"])
    if rng == "input":
        kw["uin"] = 1.0 - torch.rand((steps * fc.U_ROWS, L), generator=g,
                                     device=cuda)
        if emit == "all":
            kw["uemit"] = 1.0 - torch.rand((steps, L), generator=g,
                                           device=cuda)
    else:
        kw["seed"] = torch.tensor([17], dtype=torch.int32, device=cuda)
    th = torch.tensor([0.0, 0.0, 1.0], device=cuda)
    runs = [fc.chain_chunk(t.x2d, t.y2d, th, steps=steps, emit=emit, **kw)
            for _ in range(2)]
    buf = torch.zeros(len(fc.STAMP_PHASES), dtype=torch.int64, device=cuda)
    before = launches[fc.STAMPED_KERNEL]
    runs.append(fc.chain_chunk(t.x2d, t.y2d, th, steps=steps, emit=emit,
                               stamps=buf, **kw))
    assert launches[fc.STAMPED_KERNEL] == before + 1
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)
    split = fc.stamp_split(kw["mode"], buf, steps)
    assert all(v >= 0 for v in split.values())
    for phase in ("philox", "box_muller", "log_density", "weights_scan"):
        assert split[phase] > 0
    assert (split["jump"] > 0) == (emit == "all")


@pytest.mark.gpu
@pytest.mark.parametrize("N,depth", [(1, 9), (511, 1)])
def test_fused_chain_emit_all_kernel_rng(cuda, N, depth):
    """emit="all" with the in-kernel Philox: seeded, finite, and each
    slot's stream moves."""
    g = torch.Generator(device=cuda)
    g.manual_seed(2)
    x, y = make_synthetic_linreg(g, 5000)
    t = BayesLinReg(x, y, temper=0.01, method="fused", device=cuda)
    cfg = PMPConfig(N=N, depth=depth, step_size=0.05,
                           selection="all_first")
    run = fc.make_fused_chain(t, cfg, chunk=50, emit="all")
    th = torch.tensor([0.0, 0.0, 1.0], device=cuda)
    outs = []
    for _ in range(2):
        gen = torch.Generator(device=cuda)
        gen.manual_seed(9)
        outs.append(run(gen, th, 120))
    for k in ("root", "jumps", "last", "emit_b0"):
        assert torch.equal(outs[0][k], outs[1][k])
        assert bool(torch.isfinite(outs[0][k]).all())
    eb = outs[0]["emit_b0"]
    assert eb.shape == (cfg.P, 120)
    assert torch.equal(eb[0], outs[0]["root"][:, 0])
    assert bool((outs[0]["jumps"] >= 0).all())
    assert (eb[:, 1:] != eb[:, :-1]).any(dim=1).float().mean() > 0.9


@pytest.mark.gpu
@pytest.mark.parametrize("N,depth", [(1, 3), (1, 9), (511, 1), (7, 3)])
def test_chain_farm_is_bit_identical_to_single_chains(cuda, N, depth):
    """A farm of C = 4 chains in one launch against 4 single-chain
    launches on the same seeds and states: bit-equal."""
    from pmpx_torch.parallel import chains as tchains

    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    x, y = make_synthetic_linreg(g, 20_000)
    t = BayesLinReg(x, y, temper=0.01, method="fused", device=cuda)
    cfg = PMPConfig(N=N, depth=depth, step_size=0.05,
                           selection="all_first")
    C, steps = 4, 150
    theta0 = torch.tensor([[0.0, 0.0, 1.0], [0.1, 0.2, 0.9],
                           [-0.5, 1.0, 1.2], [-1.0, 2.0, 0.5]], device=cuda)
    farm = tchains.make_chain_farm_fused(t, cfg, steps, chunk=100)
    before = launches["fused_chain_farm"]
    got = farm(tchains.chain_generators(1, C, cuda), theta0)
    assert launches["fused_chain_farm"] == before + 2
    single = fc.make_fused_chain(t, cfg, chunk=100)
    for c, gen in enumerate(tchains.chain_generators(1, C, cuda)):
        assert torch.equal(got[c], single(gen, theta0[c], steps))
    assert bool(torch.isfinite(got).all())


@pytest.mark.gpu
@pytest.mark.parametrize("N,depth", [(1, 3), (1, 9), (511, 1)])
def test_chain_farm_injected_uniforms_match_plain(cuda, N, depth):
    """The farm on injected uniforms (each block reads its chain's rows
    of uin): chain c is bit-equal to a single-chain launch on uin[:, c],
    and held step by step against the plain version
    (fc.replay_roots_against_plain, as chip_smoke.py's phase 3e): >= 99%
    of the selections equal, the state within 1e-4 where they are."""
    from pmpx_torch.parallel import chains as tchains

    g = torch.Generator(device=cuda)
    g.manual_seed(5)
    x, y = make_synthetic_linreg(g, 20_000)
    t = BayesLinReg(x, y, temper=0.01, method="fused", device=cuda)
    cfg = PMPConfig(N=N, depth=depth, step_size=0.05, selection="all_first")
    kw = fc.chain_consts(t, cfg)
    C, steps, chunk = 4, 150, 100
    L = fc.lane_extent(kw["P"])
    uin = 1.0 - torch.rand((2, C, chunk * fc.U_ROWS, L), generator=g,
                           device=cuda)
    theta0 = torch.tensor([[0.0, 0.0, 1.0], [0.1, 0.2, 0.9],
                           [-0.5, 1.0, 1.2], [-1.0, 2.0, 0.5]], device=cuda)
    farm = tchains.make_chain_farm_fused(t, cfg, steps, chunk=chunk,
                                         rng="input")
    before = launches["fused_chain_farm"]
    got = farm(tchains.chain_generators(1, C, cuda), theta0, uin=uin)
    assert launches["fused_chain_farm"] == before + 2
    single = fc.make_fused_chain(t, cfg, chunk=chunk, rng="input")
    for c in range(C):
        u_c = uin[:, c].contiguous()
        assert torch.equal(got[c], single(None, theta0[c], steps, uin=u_c))
        agree, err, _ = fc.replay_roots_against_plain(
            t.x2d, t.y2d, theta0[c], u_c.reshape(-1, L)[:steps * fc.U_ROWS],
            got[c], **kw)
        assert agree >= 0.99 * steps
        assert err <= 1e-4


def _lstm_weights(g, P, dtype, device, scale=0.2):
    F, H = 28, 64
    Wx = (scale * torch.randn((P, F, 4 * H), generator=g, device=device)
          ).to(dtype)
    Wh = (scale * torch.randn((P, H, 4 * H), generator=g, device=device)
          ).to(dtype)
    b = 0.1 * torch.randn((P, 4 * H), generator=g, device=device)
    return Wx, Wh, b


# the kernel's 64-row tile: one row, one tile less and more by one, two
# tiles and one row, for P = 1, 2 and 8
_LSTM_EDGES = [(P, B) for P in (1, 2, 8) for B in (1, 63, 64, 65, 129)]


@pytest.mark.gpu
@pytest.mark.parametrize("x_scale", [1.0, 8.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,B", list(dict.fromkeys(
    [(8, 100), (2, 64), (1, 1000), (8, 10_000)] + _LSTM_EDGES)))
def test_lstm_fused_kernel_matches_plain(cuda, P, B, dtype, x_scale):
    """h_T of the kernel against its plain version: f32 within 2e-5
    (pmpx's kernel-vs-XLA tolerance, tests/test_lstm_kernel.py:43); bf16,
    where an f32 difference can flip one bf16 rounding of h, within 0.05
    (h in [-1, 1]).  x scaled by 8 gives the hi/lo split large exponents
    and saturates the gates.  One launch; a second launch bit-equal."""
    from pmpx_torch.kernels import lstm_fused as lf

    g = torch.Generator(device=cuda)
    g.manual_seed(P * B)
    x_tm = (x_scale * torch.randn((28, B, 28), generator=g, device=cuda)
            ).to(dtype)
    Wx, Wh, b = _lstm_weights(g, P, dtype, cuda)
    before = launches["lstm_fused"]
    got = lf.lstm_final_hidden(x_tm, Wx, Wh, b)
    assert launches["lstm_fused"] == before + 1
    want = lf.lstm_final_hidden_ref(x_tm, Wx, Wh, b)
    assert got.shape == (P, B, 64) and got.dtype == torch.float32
    atol = 2e-5 if dtype == torch.float32 else 0.05
    torch.testing.assert_close(got, want, rtol=0, atol=atol)
    assert torch.equal(got, lf.lstm_final_hidden(x_tm, Wx, Wh, b))


@pytest.mark.gpu
def test_lstm_fused_kernel_refuses_other_shapes(cuda):
    from pmpx_torch.kernels import lstm_fused as lf

    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    x_tm = torch.randn((28, 16, 20), generator=g, device=cuda)
    Wx = torch.randn((2, 20, 256), generator=g, device=cuda)
    Wh = torch.randn((2, 64, 256), generator=g, device=cuda)
    b = torch.zeros((2, 256), device=cuda)
    with pytest.raises(ValueError):
        lf.lstm_final_hidden(x_tm, Wx, Wh, b)
    with pytest.raises(TypeError):
        lf.lstm_final_hidden(x_tm.double(), Wx, Wh, b)


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_lstm_posterior_kernel_path_matches_generic(cuda, compute_dtype):
    """The attached posterior's log-densities against the generic path
    (vmap of functional_call): f32 within rtol 2e-5, bf16 within rtol
    0.02 / atol 0.05 (pmpx's tests/test_lstm_kernel.py:43, :89)."""
    from pmpx_torch.kernels import lstm_fused as lf
    from pmpx_torch.models import MnistLSTM
    from pmpx_torch.targets.nn import NNPosterior

    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    X = torch.randn((1000, 28, 28), generator=g, device=cuda)
    Y = torch.randint(0, 10, (1000,), generator=g, device=cuda)
    post = NNPosterior(MnistLSTM(), X, Y, temper=10.0, device=cuda,
                       compute_dtype=compute_dtype)
    Theta = post.init_theta() + 0.05 * torch.randn(
        (8, post.d), generator=g, device=cuda)
    want = post.log_prob_batch(Theta)
    lf.attach(post)
    before = launches["lstm_fused"]
    got = post.log_prob_batch(Theta)
    assert launches["lstm_fused"] == before + 1
    if compute_dtype is None:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(got, want, rtol=0.02, atol=0.05)
    assert torch.equal(post.log_prob(Theta[3]), got[3])


@pytest.mark.gpu
def test_lstm_pmp_replay_against_plain(cuda):
    """20 PMP supersteps (binary depth 3, single, zscore) over the
    attached posterior on injected noise, each replayed through the plain
    version from the kernel path's state: >= 99% of the selections equal
    and the states bit-equal where they are."""
    from pmpx_torch.kernels import lstm_fused as lf
    from pmpx_torch.models import MnistLSTM
    from pmpx_torch.targets.nn import NNPosterior

    g = torch.Generator(device=cuda)
    g.manual_seed(2)
    X = torch.randn((600, 28, 28), generator=g, device=cuda)
    Y = torch.randint(0, 10, (600,), generator=g, device=cuda)
    post = NNPosterior(MnistLSTM(), X, Y, temper=10.0, device=cuda)
    lf.attach(post)
    cfg = PMPConfig(N=1, depth=3, step_size=1e-2, selection="single",
                    stabilizer="zscore")
    steps = 20
    eps = 1e-2 * torch.randn((steps, 8, post.d), generator=g, device=cuda)
    u = torch.rand((steps, 1), generator=g, device=cuda)
    agree, err = lf.replay_against_plain(post, cfg, post.init_theta(), eps, u)
    assert agree >= 0.99 * steps
    assert err == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("spec", [
    dict(algo="pmp", N=1, depth=3, selection="all_first"),
    dict(algo="mp", N=7, selection="all_uniform"),
    dict(algo="mh"),
], ids=["pmp", "mp", "mh"])
def test_batched_superstep_on_the_card_matches_cpu(cuda, spec):
    """64 chains of the chain-batched superstep on the sweep at n =
    100,000 (skewness' protocol), on the card and on the CPU from the same
    injected noise: one linreg_rss launch a superstep for the whole batch,
    the same selections, the states within 1e-5."""
    from pmpx_torch.config import SamplerSpec
    from pmpx_torch.parallel import run_chains_vmapped

    C, T, n = 64, 20, 100_000
    P = {"pmp": 8, "mp": 8, "mh": 2}[spec["algo"]]
    g = torch.Generator()
    g.manual_seed(13)
    x, y = make_synthetic_linreg(g, n)
    eps = 0.02 * torch.randn((T, C) + ((3,) if P == 2 else (P, 3)),
                             generator=g)
    u = torch.rand((T, C) + (() if P == 2 else (P,)), generator=g)
    pick = torch.randint(0, P, (T, C), generator=g)
    theta0 = torch.tensor([-1.0, 2.0, 0.5]).repeat(C, 1)
    theta0 = theta0 + 0.05 * torch.randn((C, 3), generator=g)

    def run(dev):
        tgt = BayesLinReg(x, y, temper=1 / 2000, method="sweep", device=dev)
        sup = SamplerSpec(step_size=0.02, **spec).build(tgt)
        # step t's noise through a counter on the device, so that the
        # card's run_chain replays it from its CUDA graph
        noise = dict(eps=eps.to(dev), u=u.to(dev))
        if P != 2:
            noise["pick"] = pick.to(dev)
        t = torch.zeros(1, dtype=torch.long, device=dev)

        def replay(gen, th):
            kw = {k: v.index_select(0, t)[0] for k, v in noise.items()}
            t.add_(1)
            return sup(gen, th, **kw)

        return run_chains_vmapped(replay, None, theta0.to(dev), T,
                                  collect=lambda th, o: th)[1].cpu()

    want = run("cpu")
    before = launches["linreg_rss"]
    got = run(cuda)
    torch.cuda.synchronize()
    assert launches["linreg_rss"] - before == T
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


# checkpoint/resume and the HMC family on the card


@pytest.mark.gpu
def test_cuda_generator_state_restores_the_offset(cuda, tmp_path):
    """A CUDA Philox generator's saved state (seed and offset) restores
    the stream exactly, through a checkpoint file."""
    from pmpx_torch import checkpoint as ck

    g = torch.Generator(device=cuda)
    g.manual_seed(5)
    torch.randn(1001, generator=g, device=cuda)  # move the offset
    path = ck.save_checkpoint(str(tmp_path / "g.ckpt"),
                              torch.zeros(3, device=cuda), g, 7)
    want = torch.randn(4096, generator=g, device=cuda)
    _, g2, step, _ = ck.load_checkpoint(path)
    assert step == 7 and g2.device.type == "cuda"
    assert torch.equal(torch.randn(4096, generator=g2, device=cuda), want)


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["pmp", "sp_hmc", "mp_hmc", "pmp_hmc"])
def test_chunked_chain_on_the_card_is_one_run_chain(cuda, tmp_path, algo):
    """On the sweep (linreg_rss a density evaluation), chunks of 7 with a
    checkpoint between them give one run_chain's states bit for bit."""
    from pmpx_torch import checkpoint as ck
    from pmpx_torch.config import SamplerSpec
    from pmpx_torch.samplers.base import run_chain

    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    x, y = make_synthetic_linreg(g, 100_000)
    tgt = BayesLinReg(x, y, temper=1 / 2000, method="sweep", device=cuda)
    step = 0.02 if algo == "pmp" else 0.0005
    sup = SamplerSpec(algo=algo, N=3, depth=2, step_size=step).build(tgt)
    theta0 = torch.tensor([-1.0, 2.0, 0.5], device=cuda)
    g.manual_seed(1)
    with torch.no_grad():
        before = launches["linreg_rss"]
        thF, recs = run_chain(sup, g, theta0, 30,
                              collect=lambda th, o: th)
        torch.cuda.synchronize()
        assert launches["linreg_rss"] > before
        path = str(tmp_path / "c.ckpt")
        g.manual_seed(1)
        ck.save_checkpoint(path, theta0, g, 0)
        th, chunks = ck.resume_chain(sup, path, 30,
                                     collect=lambda th, o: th,
                                     checkpoint_every=7)
    assert torch.equal(th, thF)
    assert torch.equal(torch.cat([torch.from_numpy(c) for c in chunks]),
                       recs.cpu())


@pytest.mark.gpu
def test_lenet_posterior_on_the_card_matches_the_cpu(cuda):
    """LeNet's value and gradient on the card (cuDNN's convolutions, TF32
    off) against the CPU's, P = 4 over 64 images."""
    from pmpx_torch.models import LeNet
    from pmpx_torch.targets.nn import NNPosterior

    g = torch.Generator().manual_seed(0)
    X = torch.randn(64, 32, 32, 3, generator=g)
    Y = torch.randint(0, 10, (64,), generator=g)
    cpu = NNPosterior(LeNet(), X, Y, device="cpu")
    gpu = NNPosterior(LeNet(), X, Y, device=cuda)
    Theta = cpu.init_theta() + 0.05 * torch.randn(4, cpu.d, generator=g)
    cv, cg = cpu.value_and_grad_batch(Theta)
    gv, gg = gpu.value_and_grad_batch(Theta.to(cuda))
    torch.testing.assert_close(gv.cpu(), cv, rtol=1e-5, atol=0)
    torch.testing.assert_close(gg.cpu(), cg, rtol=0,
                               atol=1e-4 * float(cg.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_cnn_fast_on_the_card_matches_generic(cuda, compute_dtype):
    """The space-to-depth CNN density (cuDNN and cuBLAS, TF32 off) against
    the generic path on the card and, in f32, the CPU's, P = 8 over 512
    images: rtol and atol 2e-5 in f32, 2e-2 in bf16 (pmpx's
    tests/test_cnn_fast.py:36-51)."""
    from pmpx_torch.kernels import cnn_fast
    from pmpx_torch.models import MnistCNN
    from pmpx_torch.targets.nn import NNPosterior

    g = torch.Generator().manual_seed(1)
    X = torch.randn(512, 28, 28, generator=g)
    Y = torch.randint(0, 10, (512,), generator=g)
    gpu = NNPosterior(MnistCNN(), X, Y, temper=10.0, device=cuda,
                      compute_dtype=compute_dtype)
    Theta = gpu.init_theta().cpu() + 0.3 * torch.randn(8, gpu.d, generator=g)
    tol = 2e-5 if compute_dtype is None else 2e-2
    with torch.no_grad():
        generic = gpu.log_prob_batch(Theta.to(cuda))
        fast = cnn_fast.make_fast_log_prob_batch(gpu)(Theta.to(cuda))
        gpu.proposal_chunk = 2
        chunked = cnn_fast.make_fast_log_prob_batch(gpu)(Theta.to(cuda))
    torch.testing.assert_close(fast, generic, rtol=tol, atol=tol)
    # another chunk is another convolution shape (cuDNN may pick another
    # algorithm), so the chunked densities agree to the same tolerance
    torch.testing.assert_close(chunked, fast, rtol=tol, atol=tol)
    if compute_dtype is None:
        cpu = NNPosterior(MnistCNN(), X, Y, temper=10.0, device="cpu")
        with torch.no_grad():
            want = cnn_fast.make_fast_log_prob_batch(cpu)(Theta)
        torch.testing.assert_close(fast.cpu(), want, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("model", ["lenet", "cnn"])
def test_packed_on_the_card_matches_generic(cuda, model, remat):
    """The channel-packed LeNet and MnistCNN against the NHWC models on
    the card, value and gradient at P = 2 over 256 images: values rtol
    1e-5, gradients within 1e-4 max|g|."""
    from pmpx_torch.models import LeNet, MnistCNN, PackedLeNet, PackedMnistCNN
    from pmpx_torch.targets.nn import NNPosterior

    nhwc_cls, packed_cls, shape = {
        "lenet": (LeNet, PackedLeNet, (32, 32, 3)),
        "cnn": (MnistCNN, PackedMnistCNN, (28, 28))}[model]
    g = torch.Generator().manual_seed(2)
    X = torch.randn(256, *shape, generator=g)
    Y = torch.randint(0, 10, (256,), generator=g)
    nhwc = NNPosterior(nhwc_cls(), X, Y, device=cuda)
    packed = NNPosterior(packed_cls(remat=remat), X, Y, device=cuda)
    Theta = nhwc.init_theta() + 0.05 * torch.randn(
        2, nhwc.d, generator=g).to(cuda)
    nv, ng = nhwc.value_and_grad_batch(Theta)
    pv, pg = packed.value_and_grad_batch(Theta)
    torch.testing.assert_close(pv, nv, rtol=1e-5, atol=0)
    torch.testing.assert_close(pg, ng, rtol=0,
                               atol=1e-4 * float(ng.abs().max()))


# the mesh on the card: a one-rank NCCL world in this process, and gloo
# ranks that share the card (NCCL refuses two ranks on one GPU)


@pytest.mark.gpu
def test_one_rank_nccl_mesh_equals_the_unsharded_paths(cuda):
    import torch.distributed as dist

    from pmpx_torch import parallel as par

    mesh = par.make_mesh(devices="cuda")
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    try:
        _one_rank_equalities(cuda, mesh)
    finally:
        dist.destroy_process_group()


def _one_rank_equalities(cuda, mesh):
    from pmpx_torch import parallel as par
    from pmpx_torch.samplers import pmp

    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    x, y = make_synthetic_linreg(g, 5000)
    target = BayesLinReg(x, y, temper=0.02, method="sweep", device=cuda)
    cfg = PMPConfig(N=1, depth=5, step_size=0.05, selection="all_first")
    sup = pmp.make_superstep(target, cfg)
    th = torch.tensor([[0.0, 0.0, 1.0]] * 4, device=cuda)
    got = par.run_chains_sharded(sup, 3, th, 10, mesh, device=cuda)
    want = par.run_chains_vmapped(
        sup, par.chain_generators(3, 1, cuda)[0], th, 10)
    assert torch.equal(got[0], want[0])
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k
    Theta = th[:1] + 0.1 * torch.randn((64, 3), generator=g, device=cuda)
    sh = par.ShardedLinReg(x, y, 5000, temper=0.02, mesh=mesh)
    assert torch.equal(sh.log_prob_batch(Theta),
                       target.log_prob_batch(Theta))
    eps = 0.05 * torch.randn((cfg.P, 3), generator=g, device=cuda)
    u = torch.rand((cfg.P,), generator=g, device=cuda)
    a = par.make_tree_sharded_superstep(target, cfg, mesh=mesh)(
        None, th[0], eps=eps, u=u)
    b = sup(None, th[0], eps=eps, u=u)
    assert torch.equal(a[0], b[0])
    for k in b[1]:
        assert torch.equal(a[1][k], b[1][k]), k
    before = launches[fc.FARM_KERNEL]
    roots = [par.run_chains_fused(target, cfg, par.chain_generators(
        5, 4, cuda), th, 64, m, chunk=32) for m in (mesh, None)]
    assert launches[fc.FARM_KERNEL] == before + 4
    assert torch.equal(roots[0], roots[1])


def _gloo_data_rank(rank, world, init_file, out):
    """One rank of a gloo world on the card: the data axis's log-densities
    of 64 proposals over its shard of 8192 points."""
    from datetime import timedelta

    import torch.distributed as dist

    from pmpx_torch import parallel as par
    from pmpx_torch.parallel import mesh as pm

    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    x, y, Theta = _gloo_data_inputs(dev)
    mesh = par.make_mesh(data=world)
    d = mesh.get_local_rank("data")
    m = x.shape[0] // world
    sh = par.ShardedLinReg(x[d * m:(d + 1) * m], y[d * m:(d + 1) * m],
                           x.shape[0], temper=0.02, mesh=mesh)
    before = launches["linreg_rss"]
    logp = sh.log_prob_batch(Theta)
    torch.save({"logp": logp.cpu(), "device": logp.device.type,
                "launches": launches["linreg_rss"] - before,
                "routes": pm.routes}, out)
    dist.destroy_process_group()


def _gloo_data_inputs(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    x, y = make_synthetic_linreg(g, 8192)
    Theta = torch.tensor([0.0, 0.0, 1.0], device=dev) + 0.1 * torch.randn(
        (64, 3), generator=g, device=dev)
    return x, y, Theta


@pytest.mark.gpu
def test_gloo_ranks_on_the_card_hold_the_data_axis(cuda, tmp_path):
    """2 gloo ranks that share the card: each rank's linreg_rss on the
    card, the partial sums through the host, the log-densities within rtol
    1e-5 of the unsharded sweep (the f32 summation order differs)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(here.parent), str(here), os.environ.get("PYTHONPATH", "")]))
    code = ("import sys, test_torch_gpu as t; "
            "t._gloo_data_rank(*sys.argv[1:])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), "2", str(tmp_path / "init"),
         str(tmp_path / f"rank{r}.pt")], env=env) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0]
    x, y, Theta = _gloo_data_inputs(cuda)
    want = BayesLinReg(x, y, temper=0.02, method="sweep",
                       device=cuda).log_prob_batch(Theta).cpu()
    for r in range(2):
        res = torch.load(tmp_path / f"rank{r}.pt")
        assert res["device"] == "cuda" and res["launches"] == 1
        assert res["routes"]["all_reduce"]["host"] == 1
        torch.testing.assert_close(res["logp"], want, rtol=1e-5, atol=0)


# the data-sharded NN posterior on the card: sync-BN inside the
# torch.func transforms


def _lenet_posterior(dev, n=256, remat=False):
    from pmpx_torch.data import load_cifar10
    from pmpx_torch.models import LeNet
    from pmpx_torch.targets.nn import NNPosterior

    x, y, _, _ = load_cifar10(n_train=n, n_test=8, device=dev)
    post = NNPosterior(LeNet(remat=remat), x, y, temper=0.5, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    Theta = post.init_theta() + 0.02 * torch.randn(
        (2, post.d), generator=g, device=dev)
    return post, x, y, Theta


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [False, True])
def test_one_rank_nccl_sharded_lenet_equals_the_posterior(cuda, remat):
    """data=1 on NCCL: log_prob_batch and the values bit for bit, the
    gradients within 1e-5 max|g| (the backward of the concatenated
    statistics may sum in another order), every collective direct."""
    import torch.distributed as dist

    from pmpx_torch import parallel as par
    from pmpx_torch.parallel import mesh as pm

    mesh = par.make_mesh(devices="cuda")
    try:
        post, x, y, Theta = _lenet_posterior(cuda, remat=remat)
        s = par.ShardedNNPosterior.from_posterior(post, x, y, x.shape[0],
                                                  mesh=mesh)
        host = pm.routes["all_reduce"]["host"]
        assert torch.equal(s.log_prob_batch(Theta),
                           post.log_prob_batch(Theta))
        (sv, sg), (tv, tg) = (p.value_and_grad_batch(Theta)
                              for p in (s, post))
        assert torch.equal(sv, tv)
        torch.testing.assert_close(sg, tg, rtol=0,
                                   atol=1e-5 * float(tg.abs().max()))
        assert torch.equal(s.accuracy(Theta[0]), post.accuracy(Theta[0]))
        assert pm.routes["all_reduce"]["host"] == host
    finally:
        dist.destroy_process_group()


def _gloo_bn_rank(rank, world, init_file, out):
    """One rank of a gloo world on the card: its shard of 256 CIFAR
    stand-ins under the sharded LeNet, sync-BN through the host."""
    from datetime import timedelta

    import torch.distributed as dist

    from pmpx_torch import parallel as par
    from pmpx_torch.parallel import mesh as pm

    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    post, x, y, Theta = _lenet_posterior(dev)
    mesh = par.make_mesh(data=world)
    m = x.shape[0] // world
    s = par.ShardedNNPosterior.from_posterior(
        post, x[rank * m:(rank + 1) * m], y[rank * m:(rank + 1) * m],
        x.shape[0], mesh=mesh)
    v, g = s.value_and_grad_batch(Theta)
    torch.save({"v": v.cpu(), "g": g.cpu(), "device": g.device.type,
                "routes": pm.routes}, out)
    dist.destroy_process_group()


@pytest.mark.gpu
def test_gloo_ranks_on_the_card_sync_batch_norm(cuda, tmp_path):
    """2 gloo ranks that share the card: every BatchNorm's statistics and
    their adjoints go through the host (2 BatchNorms x 2 passes, plus the
    values and gradients), the computation stays on the card, and the
    values and gradients are the unsharded posterior's within pmpx's
    tolerances (tests/test_sharded_nn.py:62-69)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(here.parent), str(here), os.environ.get("PYTHONPATH", "")]))
    code = ("import sys, test_torch_gpu as t; "
            "t._gloo_bn_rank(*sys.argv[1:])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), "2", str(tmp_path / "init"),
         str(tmp_path / f"rank{r}.pt")], env=env) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=180)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0]
    post, _, _, Theta = _lenet_posterior(cuda)
    wv, wg = (a.cpu() for a in post.value_and_grad_batch(Theta))
    for r in range(2):
        res = torch.load(tmp_path / f"rank{r}.pt")
        assert res["device"] == "cuda"
        assert res["routes"]["all_reduce"] == {"direct": 0, "host": 6}
        torch.testing.assert_close(res["v"], wv, rtol=2e-5, atol=1e-6)
        torch.testing.assert_close(res["g"], wg, rtol=5e-3, atol=1e-5)


# the compiled chain: run_chain replays a captured CUDA graph of the
# superstep on the card; run_chain_eager is its plain version


def _linreg_sweep(dev, n=100_000, seed=0, temper=1 / 2000):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x, y = make_synthetic_linreg(g, n)
    return BayesLinReg(x, y, temper=temper, method="sweep", device=dev)


def _same_tree(a, b):
    from pmpx_torch.samplers import base

    la, lb = base._leaves(a), base._leaves(b)
    assert type(a) is type(b) and len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


def _captured_vs_eager(sup, theta0, steps, collect=None, unroll=1,
                       seed=3):
    """One run_chain (captured) and one run_chain_eager from generators
    of one seed: records, final state and generator state bit-equal, and
    the same kernel launches; then two runs more of one compiled chain,
    the second only replaying, against two more of the loop."""
    from pmpx_torch.kernels import reset_launches
    from pmpx_torch.samplers.base import compile_chain, eager_reason, \
        run_chain, run_chain_eager

    assert eager_reason(sup, theta0) is None
    dev = theta0.device
    ga = torch.Generator(device=dev)
    ga.manual_seed(seed)
    gb = torch.Generator(device=dev)
    gb.manual_seed(seed)
    reset_launches()
    fa, ra = run_chain_eager(sup, ga, theta0, steps, collect=collect)
    want = {k: v for k, v in launches.items() if v}
    reset_launches()
    fb, rb = run_chain(sup, gb, theta0, steps, collect=collect,
                       unroll=unroll)
    torch.cuda.synchronize()
    assert {k: v for k, v in launches.items() if v} == want
    _same_tree(fa, fb)
    _same_tree(ra, rb)
    assert torch.equal(ga.get_state(), gb.get_state())
    # one compiled chain from where the first runs left off: its first run
    # captures, its second only replays
    chain = compile_chain(sup, gb, fb, collect, unroll)
    for _ in range(2):
        fa, ra = run_chain_eager(sup, ga, fa, steps, collect=collect)
        chunks = dict(chain.chunks)
        fb, rb = chain.run(gb, fb, steps)
        _same_tree(fa, fb)
        _same_tree(ra, rb)
        assert torch.equal(ga.get_state(), gb.get_state())
    assert chain.chunks == chunks and sorted(chunks) == sorted({1, unroll})
    return want


COMPILED_SPECS = {
    "pmp_binary": dict(algo="pmp", N=1, depth=10, selection="all_first"),
    "pmp_uniform": dict(algo="pmp", N=1, depth=4, selection="all_uniform"),
    "pmp_general": dict(algo="pmp", N=7, depth=3, selection="all_first"),
    "mp": dict(algo="mp", N=7, selection="all_first"),
    "psp": dict(algo="psp", P=16),
    "mh": dict(algo="mh"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("unroll", [1, 3])
@pytest.mark.parametrize("name", sorted(COMPILED_SPECS))
def test_compiled_chain_equals_the_eager_loop(cuda, name, unroll):
    """10 supersteps over linreg at n = 100,000 on the sweep, captured
    (unroll 1, or 3 with a tail) against the eager loop: bit-equal
    records (through a dict and a tuple collect), final state and
    generator state, one linreg_rss launch a superstep counted per
    replay."""
    from pmpx_torch.config import SamplerSpec

    spec = dict(COMPILED_SPECS[name])
    if spec["algo"] == "psp":
        from pmpx_torch.samplers import psp

        sup = psp.make_superstep(_linreg_sweep(cuda), psp.PSPConfig(
            P=spec["P"], step_size=0.02))
    else:
        sup = SamplerSpec(step_size=0.02, **spec).build(_linreg_sweep(cuda))
    theta0 = torch.tensor([0.0, 0.0, 1.0], device=cuda)
    collect = None if unroll == 1 else (lambda th, o: (th, o["root_logp"]))
    with torch.no_grad():
        counts = _captured_vs_eager(sup, theta0, 10, collect, unroll)
    assert counts == {"linreg_rss": 10}


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["pmp", "mh"])
def test_compiled_chain_batched_chains(cuda, algo):
    """C = 8 chains as one (8, 3) state: one launch a superstep, captured
    against eager bit for bit."""
    from pmpx_torch.config import SamplerSpec

    sup = SamplerSpec(algo=algo, N=1, depth=3, step_size=0.02,
                      selection="all_first").build(_linreg_sweep(cuda))
    g = torch.Generator(device=cuda)
    g.manual_seed(8)
    theta0 = (torch.tensor([-1.0, 2.0, 0.5], device=cuda)
              + 0.05 * torch.randn((8, 3), generator=g, device=cuda))
    with torch.no_grad():
        counts = _captured_vs_eager(sup, theta0, 12,
                                    lambda th, o: th, unroll=4)
    assert counts == {"linreg_rss": 12}


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["sp_hmc", "mp_hmc", "pmp_hmc"])
def test_compiled_hmc_over_linreg(cuda, algo):
    """SP-, MP- and PMP-HMC over linreg on the sweep (a gradient a density
    call), captured against eager bit for bit."""
    from pmpx_torch.config import SamplerSpec

    sup = SamplerSpec(algo=algo, N=3, depth=2, step_size=0.0005).build(
        _linreg_sweep(cuda))
    theta0 = torch.tensor([-1.0, 2.0, 0.5], device=cuda)
    with torch.no_grad():
        counts = _captured_vs_eager(sup, theta0, 8, lambda th, o: th)
    assert counts["linreg_rss"] > 8


@pytest.mark.gpu
def test_compiled_chain_resumes_bit_equal(cuda, tmp_path, monkeypatch):
    """resume_chain in chunks of 7 (one graph, captured once) equals one
    straight captured run_chain and the eager loop, in states, records
    and the generator's saved state."""
    from pmpx_torch import checkpoint as ck
    from pmpx_torch.config import SamplerSpec
    from pmpx_torch.samplers import base

    captures = []
    capture = base.CompiledChain._capture
    monkeypatch.setattr(base.CompiledChain, "_capture", lambda self, k: (
        captures.append(k), capture(self, k))[1])

    sup = SamplerSpec(algo="pmp", N=7, depth=3, step_size=0.02,
                      selection="all_first").build(_linreg_sweep(cuda))
    theta0 = torch.tensor([0.0, 0.0, 1.0], device=cuda)
    ge = torch.Generator(device=cuda)
    ge.manual_seed(1)
    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    with torch.no_grad():
        thE, recE = base.run_chain_eager(sup, ge, theta0, 30,
                                         collect=lambda th, o: th)
        path = str(tmp_path / "c.ckpt")
        ck.save_checkpoint(path, theta0, g, 0)
        th, chunks = ck.resume_chain(sup, path, 30,
                                     collect=lambda th, o: th,
                                     checkpoint_every=7)
        straight = base.run_chain(sup, g, theta0, 30,
                                  collect=lambda th, o: th)
    assert captures == [1, 1]  # one for the resumed run, one for straight
    assert torch.equal(straight[0], thE) and torch.equal(straight[1], recE)
    assert torch.equal(th, thE)
    assert torch.equal(torch.cat([torch.from_numpy(c) for c in chunks]),
                       recE.cpu())
    _, g2, step, _ = ck.load_checkpoint(path)
    assert step == 30 and torch.equal(g2.get_state(), ge.get_state())


@pytest.mark.gpu
def test_capturing_a_host_read_raises(cuda):
    """A superstep that reads a value back to the host cannot be captured:
    run_chain raises, naming it, and never falls back to the loop."""
    from pmpx_torch.samplers.base import run_chain

    def reads_back(gen, theta):
        if theta.sum().item() > 1e9:
            theta = theta * 0
        return theta + 1.0, {"x": theta}

    th = torch.zeros(3, device=cuda)
    with pytest.raises(RuntimeError, match="reads_back"):
        run_chain(reads_back, None, th, 4)
    torch.cuda.synchronize()
    # the card is still usable
    assert torch.equal(th + 1, torch.ones(3, device=cuda))


@pytest.mark.gpu
def test_compiled_chain_launches_match_the_graph(cuda):
    """The launches run_chain counts are the kernels the card runs: each
    replay adds the launches its capture saw, one linreg_rss kernel node a
    wrapper call (bench.graph_nodes), so R supersteps count R launches."""
    from pmpx_torch import bench
    from pmpx_torch.config import SamplerSpec
    from pmpx_torch.kernels import reset_launches
    from pmpx_torch.samplers import base

    tgt = _linreg_sweep(cuda)
    b0, b1, _ = pad_proposals(torch.zeros(1024, device=cuda),
                              torch.zeros(1024, device=cuda))
    nodes = bench.graph_nodes(lambda: batched_rss(
        b0, b1, tgt.x2d, tgt.y2d, n_valid=tgt.n))
    assert nodes["kernels"] == 1
    sup = SamplerSpec(algo="pmp", N=1, depth=10, step_size=0.02,
                      selection="all_first").build(tgt)
    theta0 = torch.tensor([0.0, 0.0, 1.0], device=cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    chain = base.compile_chain(sup, g, theta0, unroll=2)
    with torch.no_grad():
        chain.run(g, theta0, 5)
        reset_launches()
        chain.run(g, theta0, 25)
    assert chain.chunks[2].counts == {"linreg_rss": 2 * nodes["kernels"]}
    assert chain.chunks[1].counts == {"linreg_rss": nodes["kernels"]}
    assert launches["linreg_rss"] == 25 * nodes["kernels"]


@pytest.mark.gpu
def test_time_sweep_captures_outside_its_window(cuda, monkeypatch):
    """bench.time_sweep compiles its chain and captures it in the warm-up:
    nothing is captured between before_timed() and the end of the timed
    run, which counts one linreg_rss launch a superstep."""
    from pmpx_torch import bench
    from pmpx_torch.kernels import reset_launches
    from pmpx_torch.samplers import base

    captures, marks = [], []
    capture = base.CompiledChain._capture
    monkeypatch.setattr(base.CompiledChain, "_capture", lambda self, k: (
        captures.append(k), capture(self, k))[1])

    def before_timed():
        reset_launches()
        marks.append(len(captures))

    with torch.no_grad():
        us, trace = bench.time_sweep(_linreg_sweep(cuda), bench.bench_config(),
                                     before_timed=before_timed)
    assert captures == [1] and marks == [1]
    assert launches["linreg_rss"] == bench.SWEEP_ITERS
    assert trace.shape == (bench.SWEEP_ITERS, 3) and us > 0


@pytest.mark.gpu
def test_a_state_that_mixes_devices_raises_on_the_card(cuda):
    """A state with one leaf on the card and one off it raises in
    eager_reason and run_chain; it never runs as the loop."""
    from pmpx_torch.config import SamplerSpec
    from pmpx_torch.samplers.base import eager_reason, run_chain

    sup = SamplerSpec(algo="mh", step_size=0.02).build(_linreg_sweep(cuda))
    mixed = (torch.zeros(3, device=cuda), torch.zeros(3))
    with pytest.raises(ValueError, match="mixes CUDA tensors"):
        eager_reason(sup, mixed)
    with pytest.raises(ValueError, match="mixes CUDA tensors"):
        run_chain(sup, None, mixed, 2)


# the NN experiments' run(), captured (the default) and with the loop forced:
# the same outputs
NN_RUNS = {
    "mnist_FC_pmp": ("mnist", dict(model="FC", algo="pmp", n_train=256,
                                   n_test=64, num_steps=6, chunk_steps=0)),
    "mnist_FC_mh_chunked": ("mnist", dict(
        model="FC", algo="mh", n_train=256, n_test=64, num_steps=6,
        chunk_steps=3)),
    "mnist_LSTM_kernel": ("mnist", dict(
        model="LSTM", algo="pmp", n_train=256, n_test=64, num_steps=4,
        chunk_steps=0, lstm_kernel=True)),
    "mnist_CNN_kernel": ("mnist", dict(
        model="CNN", algo="pmp", n_train=256, n_test=64, num_steps=4,
        chunk_steps=0, cnn_kernel=True)),
    "cifar_nhwc_sp": ("cifar_hmc", dict(algo="sp_hmc", n_train=128,
                                        n_test=32, num_steps=4)),
    "cifar_packed_pmp": ("cifar_hmc", dict(
        algo="pmp_hmc", layout="packed", n_train=128, n_test=32,
        num_steps=4, chunk_steps=2)),
    "cifar_remat_mp": ("cifar_hmc", dict(algo="mp_hmc", remat=True,
                                         n_train=128, n_test=32,
                                         num_steps=4)),
    "bnn_pmp": ("bnn", dict(hidden=64, n_train=256, n_test=64,
                            num_steps=4, chunk_steps=2)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("label", sorted(NN_RUNS))
def test_nn_paths_captured_equal_the_loop(cuda, tmp_path, monkeypatch,
                                          label):
    """mnist (FC, the LSTM through lstm_fused, the CNN through cnn_fast),
    cifar_hmc (nhwc, packed, remat) and bnn (its noise a density call),
    each run with run_chain's default (captured) and with the eager loop
    forced, under deterministic algorithms: the same outputs."""
    import importlib

    from pmpx_torch.samplers import base

    mod_name, kw = NN_RUNS[label]
    mod = importlib.import_module(f"pmpx_torch.experiments.{mod_name}")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        got = mod.run(out_dir=str(tmp_path / "graph"), device=cuda, **kw)
        monkeypatch.setattr(base, "eager_reason",
                            lambda *a: "forced by the test")
        want = mod.run(out_dir=str(tmp_path / "loop"), device=cuda, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    for k, v in want.items():
        if "wall" in k or k.endswith("_s") or "us_" in k or "ms" in k:
            continue
        assert got[k] == v, (label, k)


# -- the entry points outside the package (examples/, scripts/*_torch.py) --

def _entry(rel: str):
    """An example or script of the repository, loaded by path."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / rel
    spec = importlib.util.spec_from_file_location(f"_gpu_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
def test_quickstart_example_on_card(cuda):
    """The quickstart on the card and on the CPU: the same record and
    sample shapes (the two generators' streams differ), finite values."""
    import numpy as np

    quick = _entry("examples/quickstart_torch.py")
    got = quick.main(num_steps=2100, device=cuda)
    want = quick.main(num_steps=2100, device="cpu")
    assert got["records_shape"] == want["records_shape"] == (2100, 16, 2)
    assert got["samples"].shape == want["samples"].shape == (1600, 2)
    assert np.isfinite(got["samples"]).all() and got["msjd"] > 0


@pytest.mark.gpu
def test_bayesian_nn_example_on_card(cuda):
    """bayesian_nn's captured chain on the card, its loss noise drawn
    outside the graph: the CPU run's fields, finite, the loss falling."""
    import math

    ex = _entry("examples/bayesian_nn_torch.py")
    got = ex.main(num_steps=20, device=cuda)
    want = ex.main(num_steps=20, device="cpu")
    assert set(got) == set(want)
    assert all(math.isfinite(v) for v in got.values())
    assert got["loss_last"] < got["loss_first"]


@pytest.mark.gpu
def test_run_zoo_on_card(cuda, tmp_path):
    """The zoo's 12 cells, cut to a few supersteps over a few images: the
    CPU run's rows, key for key and cell for cell."""
    zoo = _entry("scripts/run_zoo_torch.py")
    cells = [(f, dict(kw, num_steps=3, n_train=64, n_test=32,
                      pretrain_steps=1)) for f, kw in zoo.CELLS]
    got = zoo.main(cells, str(tmp_path / "card"), device=cuda)
    want = zoo.main(cells, str(tmp_path / "cpu"), device="cpu")
    for fam in ("mnist", "cifar"):
        assert [set(r) for r in got[fam]] == [set(r) for r in want[fam]]
        assert [r.get("model", "") + r["algo"] for r in got[fam]] == [
            r.get("model", "") + r["algo"] for r in want[fam]]
        assert (tmp_path / "card" / f"{fam}_zoo" / "summary.json").exists()


@pytest.mark.gpu
def test_run_paper_queue_on_card(cuda, tmp_path, monkeypatch):
    """A tiny queue on the card: an argv stage of the MNIST-LSTM MH chain
    through lstm_fused in chunks, then the summary; every stage done, the
    summary's steps the stage's, and a second run starts nothing."""
    import json

    rp = _entry("scripts/run_paper_torch.py")
    monkeypatch.setattr(rp, "STATE_DIR", str(tmp_path / "state"))
    stem = "MH_alpha_0.0001_sample_number_6LSTM_N_7"
    q = tmp_path / "q.json"
    q.write_text(json.dumps({"stages": [
        {"name": "lstm", "argv": [
            "mnist", "--model", "LSTM", "--algo", "mh", "--lstm-kernel",
            "true", "--n-train", "256", "--n-test", "64", "--num-steps",
            "6", "--chunk-steps", "2", "--pretrain-steps", "0", "--resume",
            "true", "--out-dir", str(tmp_path / "mnist_kernel")]},
        {"name": "summarize", "cmd": ["scripts/summarize_paper_torch.py",
                                      "mnist", str(tmp_path)]}]}))
    assert rp.main(str(q)) == 0
    state = tmp_path / "state"
    assert {p.name for p in state.glob("*.done")} == {"lstm.done",
                                                      "summarize.done"}
    summary = json.loads((tmp_path / "mnist" / "summary.json").read_text())
    assert summary[f"{stem}@kernel"]["steps"] == 6
    logs = {p: p.read_text() for p in state.glob("*.log")}
    assert rp.main(str(q)) == 0
    assert {p: p.read_text() for p in state.glob("*.log")} == logs


@pytest.mark.gpu
def test_profile_smallp_on_card(cuda, capsys):
    """The small-P profile: one rss_kernel launch a superstep in the timed
    run, the card's kernels in its table."""
    prof = _entry("scripts/profile_smallp_torch.py")
    got = prof.main(P=4, n_data=500, iters=50, device=cuda)
    assert got["launches"] == {"linreg_rss": 50}
    assert got["category"] == "kernel"
    assert any("rss_kernel" in name for name, _ in got["top"])
    assert "device total us/iter" in capsys.readouterr().out
