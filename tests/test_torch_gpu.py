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
    batched_rss, batched_rss_ref, pad_proposals,
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


@pytest.mark.gpu
@pytest.mark.parametrize("P,n", [(1024, 100_000), (200, 20_000), (8, 5000),
                                 (64, 300)])
def test_linreg_rss_kernel_matches_plain(cuda, P, n):
    g = torch.Generator(device=cuda)
    g.manual_seed(P)
    x, y = make_synthetic_linreg(g, n)
    x2d, y2d = pad_to_grid(x), pad_to_grid(y)
    b0, b1, _ = pad_proposals(torch.randn(P, generator=g, device=cuda),
                              torch.randn(P, generator=g, device=cuda))
    before = launches["linreg_rss"]
    got = batched_rss(b0, b1, x2d, y2d)
    assert launches["linreg_rss"] == before + 1
    want = batched_rss_ref(b0, b1, x2d, y2d)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    again = batched_rss(b0, b1, x2d, y2d)
    assert torch.equal(got, again)  # no atomics: bit for bit


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [2, 3, 7, 10])  # 2: lanes above P
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
# conv_pmp's N = 7 x depth 3 and a base of 32
NEW_MODES = [(3, 1), (199, 1), (1023, 1), (3, 2), (7, 3), (31, 2)]


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


# emit="all": binary P = 8 and 512, flat MP P = 8 and 512 (N = P - 1),
# general (3, 2) and (7, 3); all within the 512-lane cap
EMIT_MODES = [(1, 3), (1, 9), (7, 1), (511, 1), (3, 2), (7, 3)]


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
