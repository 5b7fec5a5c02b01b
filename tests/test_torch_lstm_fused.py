"""The LSTM kernel module of the port against pmpx's Pallas kernel, run as
pmpx's own tests run it on the CPU (interpret mode): the plain version of
the recurrence, the attached posterior, and attach's checks.  On the CPU
the port's wrapper runs its plain version; the CUDA kernel is held to it in
tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pmpx.kernels import lstm_fused as jlf  # noqa: E402
from pmpx.models import MnistLSTM as JLSTM  # noqa: E402
from pmpx.targets.nn import NNPosterior as JPost  # noqa: E402
from pmpx_torch.kernels import launches  # noqa: E402
from pmpx_torch.kernels import lstm_fused as tlf  # noqa: E402
from pmpx_torch.models import MnistLSTM, MnistMLP  # noqa: E402
from pmpx_torch.targets.nn import NNPosterior  # noqa: E402


def _inputs(B, P, seed):
    rng = np.random.default_rng(seed)
    x_tm = rng.standard_normal((28, B, 28)).astype(np.float32)
    Wx = (0.2 * rng.standard_normal((P, 28, 256))).astype(np.float32)
    Wh = (0.2 * rng.standard_normal((P, 64, 256))).astype(np.float32)
    b = (0.1 * rng.standard_normal((P, 256))).astype(np.float32)
    return x_tm, Wx, Wh, b


@pytest.mark.parametrize("B,block_b", [(96, 64), (100, 64), (64, 128)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ref_matches_pmpx_interpret_kernel(B, block_b, dtype):
    """lstm_final_hidden (its plain version, on the CPU) against pmpx's
    kernel in interpret mode, with pmpx tiles that do not divide B: f32
    within rtol/atol 2e-5 (pmpx's kernel-vs-XLA tolerance; measured
    2.4e-7); bf16 within atol 5e-3, a few bf16 ulps of h, where one f32
    difference can flip a bf16 rounding of h (measured 1.2e-3)."""
    x_tm, Wx, Wh, b = _inputs(B, 3, seed=B)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(jlf.lstm_final_hidden(
        jnp.asarray(x_tm, jdt), jnp.asarray(Wx, jdt), jnp.asarray(Wh, jdt),
        jnp.asarray(b), block_b=block_b, interpret=True))
    before = dict(launches)
    got = tlf.lstm_final_hidden(
        torch.tensor(x_tm).to(tdt), torch.tensor(Wx).to(tdt),
        torch.tensor(Wh).to(tdt), torch.tensor(b))
    assert launches == before  # the plain version counts no launch
    assert got.dtype == torch.float32 and got.shape == (3, B, 64)
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-3)


def _tf32_rna(a):
    """cvt.rna.tf32.f32 on finite f32 values: the mantissa rounded to 10
    bits, ties away from zero (add half of the 13 dropped bits to the
    magnitude, then drop them)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(a):
    hi = _tf32_rna(a)
    return hi, _tf32_rna(a - hi)


def _product_3xtf32(A, W):
    """A @ W as csrc/lstm_fused.cu's f32 route forms it: both operands
    split into hi = tf32(v) and lo = tf32(v - hi), lo*hi + hi*lo + hi*hi
    summed in f32 (a product of two TF32 values is exact in f32)."""
    (Ah, Al), (Wh, Wl) = _split(A), _split(W)
    return Al @ Wh + Ah @ Wl + Ah @ Wh


def _product_1xtf32(A, W):
    return _tf32_rna(A) @ _tf32_rna(W)


def _lstm_numpy(x_tm, Wx, Wh, b, product):
    """The plain recurrence in f32 NumPy with the gate product z = [x_t | h]
    [Wx ; Wh] + b formed by ``product``."""
    P, H = Wh.shape[0], Wh.shape[1]
    W = np.concatenate([Wx, Wh], axis=1)
    h = np.zeros((P, x_tm.shape[1], H), np.float32)
    c = np.zeros_like(h)
    sig = lambda v: np.float32(1) / (np.float32(1) + np.exp(-v))  # noqa
    with np.errstate(over="ignore"):
        for xt in x_tm:
            z = np.stack([product(np.concatenate([xt, h[p]], axis=1), W[p])
                          for p in range(P)]) + b[:, None, :]
            zi, zf, zg, zo = np.split(z, 4, axis=-1)
            c = sig(zf) * c + sig(zi) * np.tanh(zg)
            h = sig(zo) * np.tanh(c)
    return h


def test_tf32_emulation_rounds_like_cvt_rna():
    """The emulated cvt.rna.tf32: ties away from zero, hi + lo within
    2^-21 of the value (2^-22 from each rounding)."""
    one, tie = np.float32(1.0), np.float32(1.0 + 2.0**-11)
    assert _tf32_rna(np.array([tie, -tie])).tolist() == [1 + 2.0**-10,
                                                        -(1 + 2.0**-10)]
    assert _tf32_rna(np.array([np.float32(1.0 + 2.0**-12)]))[0] == one
    v = np.random.default_rng(0).standard_normal(10_000).astype(np.float32)
    hi, lo = _split(v)
    assert np.all(np.abs(hi + lo - v) <= 2.0**-21 * np.abs(v))


@pytest.mark.parametrize("x_scale", [1.0, 8.0])
def test_3xtf32_gate_product_keeps_f32_accuracy(x_scale):
    """The f32 kernel's 3xTF32 gate product, emulated in NumPy, through the
    plain recurrence (P = 2, B = 256): h_T within 4e-6 of the f32 plain
    version, with x scaled by 8 too (large exponents in the split,
    saturated gates)."""
    x_tm, Wx, Wh, b = _inputs(256, 2, seed=8)
    x_tm = x_scale * x_tm
    got = _lstm_numpy(x_tm, Wx, Wh, b, _product_3xtf32)
    want = tlf.lstm_final_hidden_ref(*(torch.tensor(a) for a in
                                       (x_tm, Wx, Wh, b))).numpy()
    assert np.abs(got - want).max() <= 4e-6


def test_single_pass_tf32_would_fail_the_f32_gate():
    """One TF32 product (10-bit mantissas) misses the f32 gate of 2e-5 on
    the same inputs: why the kernel splits its operands."""
    x_tm, Wx, Wh, b = _inputs(256, 2, seed=8)
    got = _lstm_numpy(x_tm, Wx, Wh, b, _product_1xtf32)
    want = tlf.lstm_final_hidden_ref(*(torch.tensor(a) for a in
                                       (x_tm, Wx, Wh, b))).numpy()
    assert np.abs(got - want).max() > 2e-5


def test_wrapper_checks_its_inputs():
    x_tm, Wx, Wh, b = (torch.tensor(a) for a in _inputs(8, 2, seed=0))
    with pytest.raises(TypeError):
        tlf.lstm_final_hidden(x_tm.double(), Wx, Wh, b)
    with pytest.raises(TypeError):
        tlf.lstm_final_hidden(x_tm, Wx.bfloat16(), Wh, b)
    with pytest.raises(ValueError):
        tlf.lstm_final_hidden(x_tm, Wx, Wh[:, :32].contiguous(), b)
    with pytest.raises(ValueError):
        tlf.lstm_final_hidden(x_tm, Wx.transpose(1, 2), Wh, b)


def _posteriors(B=64, seed=0, compute_dtype=None):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, 28, 28)).astype(np.float32)
    Y = rng.integers(0, 10, B).astype(np.int32)
    jpost = JPost(JLSTM(), jnp.asarray(X), jnp.asarray(Y), temper=10.0,
                  compute_dtype=compute_dtype and jnp.bfloat16)
    tpost = NNPosterior(MnistLSTM(), X, Y, temper=10.0, device="cpu",
                        compute_dtype=compute_dtype and torch.bfloat16)
    th0 = np.asarray(jpost._theta0)
    Theta = th0 + 0.05 * rng.standard_normal((3, th0.size)).astype(
        np.float32)
    return jpost, tpost, Theta


@pytest.mark.parametrize("compute_dtype", [None, "bf16"])
def test_attached_posterior_matches_pmpx_attached(compute_dtype):
    """The port's attached posterior against pmpx's (interpret mode) on
    the same theta and data: f32 within rtol 2e-5; bf16 within rtol 1e-5
    (both round h to bf16 in the same places; measured 1.2e-7)."""
    jpost, tpost, Theta = _posteriors(B=100, compute_dtype=compute_dtype)
    jlf.attach(jpost, block_b=64, interpret=True)
    tlf.attach(tpost)
    want = np.asarray(jpost.log_prob_batch(jnp.asarray(Theta)))
    got = tpost.log_prob_batch(torch.tensor(Theta)).numpy()
    rtol = 2e-5 if compute_dtype is None else 1e-5
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_attached_matches_generic_path_and_single_equals_batch():
    """The kernel path against the port's own generic path (rtol 2e-5,
    pmpx's tolerance), and log_prob bit-equal to log_prob_batch's row."""
    _, tpost, Theta = _posteriors(B=96, seed=3)
    Theta = torch.tensor(Theta)
    generic = tpost.log_prob_batch(Theta)
    tlf.attach(tpost)
    fast = tpost.log_prob_batch(Theta)
    np.testing.assert_allclose(fast.numpy(), generic.numpy(), rtol=2e-5)
    for p in range(3):
        assert torch.equal(tpost.log_prob(Theta[p]), fast[p])
    assert torch.equal(tpost.log_prob_batch(Theta[1:2])[0], fast[1])


def test_time_major_copy_once_per_bound_dataset():
    """x_tm is made once for the posterior's data and once more for a
    bound dataset, not once per call."""
    _, tpost, Theta = _posteriors(B=32, seed=4)
    seen = []

    def spy(x_tm, Wx, Wh, b):
        seen.append(x_tm)
        return tlf.lstm_final_hidden_ref(x_tm, Wx, Wh, b)

    tpost._fast_batch = tlf.make_fast_log_prob_batch(tpost, hidden=spy)
    Theta = torch.tensor(Theta)
    tpost.log_prob_batch(Theta)
    tpost.log_prob_batch(Theta)
    assert seen[0] is seen[1]
    X2 = torch.randn(16, 28, 28)
    with tpost.bound_data(X2, torch.zeros(16, dtype=torch.long)):
        tpost.log_prob_batch(Theta)
    assert seen[2].shape == (28, 16, 28)
    assert torch.equal(seen[2], X2.transpose(0, 1))


def test_attach_rejects_mlp_and_stochastic_posteriors():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((8, 784)).astype(np.float32)
    mlp = NNPosterior(MnistMLP(), X, np.zeros(8, np.int64), device="cpu")
    with pytest.raises(ValueError, match="MnistLSTM"):
        tlf.attach(mlp)
    _, tpost, _ = _posteriors(B=8)
    tpost.stochastic = True  # as a stochastic posterior would say
    with pytest.raises(ValueError, match="deterministic"):
        tlf.attach(tpost)
    assert tpost._fast_batch is None


def test_profiles_name_the_ports_kernels():
    """The profiler breakdown's "own" kernels are the __global__
    functions of pmpx_torch/csrc, lstm_fused_kernel, the tree kernels and
    the SSD scan among them (PyTorch keeps kernels in anonymous namespaces
    too; those are not the port's)."""
    from pmpx_torch import bench

    assert bench._own_kernels() == {
        "rss_kernel", "chain_binary_kernel", "chain_mp_kernel",
        "chain_general_kernel", "lstm_fused_kernel", "tree_positions_kernel",
        "tree_positions_inplace_kernel", "tree_select_kernel",
        "tree_gather_kernel", "mamba2_ssd_kernel"}
