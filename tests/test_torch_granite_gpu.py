"""The granite posterior's pieces on a card: the Mamba-2 SSD kernel against
its plain version at the published head shape, the binary superstep's
in-place positions (bit-equal, and one (P, d) buffer where there were
two), and one superstep of the full configuration against the plain
reference.  Marked ``gpu``; each test skips when there is no CUDA device
(decided in the test, never at import).  Run on a machine with a card
(this file imports neither JAX nor pmpx):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_granite_gpu.py
"""

import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from pmpx_torch.kernels import launches, pmp_tree  # noqa: E402
from pmpx_torch.kernels.mamba2_ssd import (  # noqa: E402
    CHUNK, mamba2_ssd, ssd_chunked_ref, ssd_sequential,
)
from pmpx_torch.samplers import pmp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ssd_inputs(S, T, H, hd, N, dtype, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=device)

    # x, B, C as a layer's conv output gives them: views of one buffer
    xbc = rn(S, T, H * hd + 2 * N).to(dtype)
    x = xbc[..., :H * hd].reshape(S, T, H, hd)
    B, C = xbc[..., H * hd:H * hd + N], xbc[..., H * hd + N:]
    dt = torch.nn.functional.softplus(rn(S, T, H) - 3.0)
    A = -torch.exp(torch.rand((S, H), generator=g, device=device) * 2.7)
    D = rn(S, H)
    return x, dt, A, B, C, D


# the published head shape (64 heads of 64, d_state 128, T = 4,096), and
# ragged lengths
@pytest.mark.gpu
@pytest.mark.parametrize("S,T,dtype", [(2, 4096, torch.bfloat16),
                                       (3, 1000, torch.bfloat16),
                                       (2, 517, torch.float32)])
def test_ssd_kernel_matches_plain(cuda, S, T, dtype):
    x, dt, A, B, C, D = _ssd_inputs(S, T, 64, 64, 128, dtype, 7, cuda)
    before = launches["mamba2_ssd"]
    y = mamba2_ssd(x, dt, A, B, C, D)
    torch.cuda.synchronize()
    assert launches["mamba2_ssd"] == before + 1
    want = ssd_chunked_ref(x.cpu(), dt.cpu(), A.cpu(), B.cpu(), C.cpu(),
                           D.cpu(), CHUNK).float()
    got = y.float().cpu()
    assert y.dtype == dtype and torch.isfinite(got).all()
    # the kernel sums in float32 in another order than the chunked sums
    # (~2^-20 of y's scale) and writes y in the inputs' type (bfloat16:
    # 2^-9 of |y|, so the two may round a value one ulp apart, at most 2^-7
    # of |y| and less of |y| plus y's rms); 2^-7 either way
    rel = 2.0 ** -7
    err = (got - want).abs()
    scale = want.abs() + want.pow(2).mean().sqrt()
    assert float((err / scale).max()) < rel


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [-3.0, 3.0])
def test_ssd_kernel_matches_recurrence(cuda, shift):
    """The kernel against its plain version, the recurrence, in float32;
    dt shifted up makes the decay pass e^-30 every few positions (the
    kernel folds it into its state and moves its base)."""
    x, dt, A, B, C, D = _ssd_inputs(2, 200, 64, 64, 128, torch.float32, 5,
                                    cuda)
    dt = torch.nn.functional.softplus(torch.log(torch.expm1(dt)) + 3.0
                                      + shift)
    y = mamba2_ssd(x, dt, A, B, C, D)
    want = ssd_sequential(*(t.cpu() for t in (x, dt, A, B, C, D)))
    got = y.cpu()
    # float32 on both sides, other orders of the same sums (y ~ 10)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) < 2e-5 * float(want.abs().max())


@pytest.mark.gpu
def test_ssd_kernel_replays_in_a_graph(cuda):
    x, dt, A, B, C, D = _ssd_inputs(4, 300, 64, 64, 128, torch.bfloat16, 3,
                                    cuda)
    first = mamba2_ssd(x, dt, A, B, C, D)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = mamba2_ssd(x, dt, A, B, C, D)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first)


@pytest.mark.gpu
@pytest.mark.parametrize("C,depth,d", [(1, 3, 1 << 17), (2, 2, 40_000),
                                       (1, 4, 70_001)])
def test_inplace_positions_bit_equal(cuda, C, depth, d):
    g = torch.Generator(device=cuda).manual_seed(depth)
    theta = torch.randn((C, d), generator=g, device=cuda)
    eps = torch.randn((C, 1 << depth, d), generator=g, device=cuda)
    before = dict(launches)
    want = pmp_tree.tree_positions(theta, eps, depth, 0.03)
    plain = pmp_tree.tree_positions_ref(theta.cpu(), eps.cpu(), depth, 0.03)
    scratch = eps.clone()
    got = pmp_tree.tree_positions(theta, scratch, depth, 0.03,
                                  overwrite=True)
    assert got.data_ptr() == scratch.data_ptr()  # written over eps
    # each kernel in its own counter
    assert {k: v - before[k] for k, v in launches.items()
            if v != before[k]} == {"pmp_tree_positions": 1,
                                   "pmp_tree_positions_inplace": 1}
    assert torch.equal(got, want) and torch.equal(got.cpu(), plain)


class _Cheap:
    """A target whose own memory is one float a row."""

    def __init__(self, d):
        self.d = d

    def log_prob_batch(self, Theta):
        return -0.5 * Theta[:, :64].pow(2).sum(1)


@pytest.mark.gpu
def test_binary_superstep_holds_one_pd_buffer(cuda):
    d, depth = 1 << 24, 3
    P = 1 << depth
    cfg = pmp.PMPConfig(N=1, depth=depth, step_size=0.01,
                        selection="single", stabilizer="zscore")
    sup = pmp.make_superstep(_Cheap(d), cfg)
    theta = torch.randn(d, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    state = gen.get_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    theta2, out = sup(gen, theta)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    buffer = P * d * 4
    # one (P, d) buffer, the next state (d) and the target's scraps
    assert peak <= buffer + 2 * d * 4 + (1 << 20)
    # bit-equal to the plain versions on the same draws
    gen.set_state(state)
    eps = torch.randn((P, d), generator=gen, device=cuda)
    u = torch.rand((1,), generator=gen, device=cuda)
    Y = pmp_tree.tree_positions_ref(theta[None].cpu(), eps[None].cpu(),
                                    depth, cfg.step_size)
    logpi = _Cheap(d).log_prob_batch(Y[0].to(cuda))
    want, _, root, _, root_logp = pmp_tree.tree_select_ref(
        cfg, Y.to(cuda), logpi[None], u[None])
    assert torch.equal(theta2, want[0])
    assert int(out["root_index"]) == int(root[0])
    assert torch.equal(out["root_logp"], root_logp[0])


@pytest.mark.gpu
def test_full_configuration_superstep_against_reference(cuda):
    sys.path.insert(0, str(ROOT))
    from benchmark import harness as H
    from benchmark.reference import checks
    from benchmark.reference import granite_hybrid as ref

    cell = H.load_cell("granite-h-micro-pmp")
    model = cell.module("models", "granite_hybrid")
    limit = cell.limits["logp_gap"]["limit"]
    inp = model.inputs(cell.config, 2**31 + 11, cuda)
    superstep, theta0 = model.program_chain(cell.config, inp, cuda)
    gen = torch.Generator(device=cuda).manual_seed(2**33 + 1)
    before = dict(launches)
    with torch.no_grad():
        theta, out = superstep(gen, theta0)
    torch.cuda.synchronize()
    mamba = cell.config["layer_types"][:10].count("mamba")
    # every layer's scan, the positions over the innovations, the select
    # and its gather of the 772 M-element root
    assert {k: v - before[k] for k, v in launches.items()
            if v != before[k]} == {"mamba2_ssd": mamba,
                                   "pmp_tree_positions_inplace": 1,
                                   "pmp_tree_select": 1,
                                   "pmp_tree_gather": 1}
    want = ref.log_density([theta], inp["tokens"], cell.config)
    gap = checks.logp_gap(out["root_logp"].reshape(1), want)
    print(json.dumps({"root_logp": float(out["root_logp"]),
                      "reference": float(want[0]), "logp_gap": gap,
                      "peak_bytes": torch.cuda.max_memory_allocated()}))
    assert gap <= limit
