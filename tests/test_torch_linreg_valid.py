"""The sweep over the real points only (``batched_rss(..., n_valid=n)``,
the zero tail never read) against pmpx's padded sweep and float64, and
the sweep's log-densities, which now take it, against pmpx.

Tolerances.  pmpx's f32 padded sum sits about 1.2e-5 (relative) off its
float64 value (tests/test_torch_linreg.py), and subtracting pad*b0^2
keeps that absolute error: the real-point sum is held to pmpx's corrected
value within 2e-5 of pmpx's padded sum, which is rtol 2e-5 where there
is no tail (n = 16,384).  Against float64 over the same f32 inputs every
value is within 1e-6 of the magnitude of its terms, sum (|y| + |b0| +
|b1 x|)^2, and within rtol 1e-6 of itself where the sum has many terms;
a single point (n = 1) can cancel in y - b0 - b1 x, and there only the
first bound is one f32 can meet.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pmpx.kernels import linreg as jk  # noqa: E402
from pmpx.targets import linreg as jlin  # noqa: E402
from pmpx_torch.interop import linreg_from_numpy  # noqa: E402
from pmpx_torch.kernels import launches  # noqa: E402
from pmpx_torch.kernels import linreg as tk  # noqa: E402
from pmpx_torch.targets import linreg as tlin  # noqa: E402


def _np(a):
    return np.array(a)


def _data(n, seed):
    x, y = jlin.make_synthetic_linreg(jax.random.key(seed), n)
    return _np(x), _np(y)


@pytest.mark.parametrize("P", [8, 64])
@pytest.mark.parametrize("n", [1, 16_384, 100_000])
def test_real_point_sum_against_pmpx_and_float64(n, P):
    x, y = _data(n, n % 97)
    x2d, y2d = jlin.pad_to_grid(jnp.asarray(x)), jlin.pad_to_grid(
        jnp.asarray(y))
    rng = np.random.default_rng(P + n)
    b0 = (-1.0 + 0.3 * rng.normal(size=P)).astype(np.float32)
    b1 = (2.0 + 0.3 * rng.normal(size=P)).astype(np.float32)
    tx2d = tlin.pad_to_grid(torch.tensor(x))
    ty2d = tlin.pad_to_grid(torch.tensor(y))
    np.testing.assert_array_equal(tx2d.numpy(), _np(x2d))
    tb0, tb1 = torch.tensor(b0), torch.tensor(b1)

    before = launches["linreg_rss"]
    got = tk.batched_rss(tb0, tb1, tx2d, ty2d, n_valid=n).numpy()
    assert launches["linreg_rss"] == before  # a CPU tensor: plain version
    np.testing.assert_array_equal(
        got, tk.batched_rss_ref(tb0, tb1, tx2d, ty2d, n_valid=n).numpy())

    # pmpx's padded sweep less the padded points' b0^2
    raw = _np(jk.batched_rss_xla(jnp.asarray(b0), jnp.asarray(b1), x2d,
                                 y2d)).astype(np.float64)
    pad = x2d.size - n
    corrected = raw - pad * b0.astype(np.float64) ** 2
    assert np.all(np.abs(got - corrected) <= 2e-5 * raw)
    if pad == 0:
        np.testing.assert_allclose(got, corrected, rtol=2e-5)

    X, Y = x.astype(np.float64), y.astype(np.float64)
    B0, B1 = b0.astype(np.float64)[:, None], b1.astype(np.float64)[:, None]
    exact = ((Y[None] - B0 - B1 * X[None]) ** 2).sum(1)
    terms = ((np.abs(Y[None]) + np.abs(B0) + np.abs(B1 * X[None])) ** 2
             ).sum(1)
    assert np.all(np.abs(got - exact) <= 1e-6 * terms)
    if n > 1:
        np.testing.assert_allclose(got, exact, rtol=1e-6)


def test_real_point_sum_reads_no_slot_past_n_valid():
    """Whatever the tail holds, the sum over the first n points is the
    same, and n_valid = every slot is the padded contract."""
    x, y = _data(3000, 2)
    x2d = tlin.pad_to_grid(torch.tensor(x))
    y2d = tlin.pad_to_grid(torch.tensor(y))
    b0, b1 = torch.full((8,), -1.0), torch.linspace(1.0, 3.0, 8)
    want = tk.batched_rss(b0, b1, x2d, y2d, n_valid=3000)
    x2d.view(-1)[3000:] = 7.0
    y2d.view(-1)[3000:] = -5.0
    assert torch.equal(tk.batched_rss(b0, b1, x2d, y2d, n_valid=3000), want)
    assert torch.equal(
        tk.batched_rss(b0, b1, x2d, y2d, n_valid=x2d.numel()),
        tk.batched_rss(b0, b1, x2d, y2d))


@pytest.mark.parametrize("n_valid,exc", [(0, ValueError), (-3, ValueError),
                                         (16_385, ValueError),
                                         (2.5, TypeError)])
def test_n_valid_must_count_slots(n_valid, exc):
    g = torch.zeros(128, 128)
    b = torch.zeros(64)
    with pytest.raises(exc):
        tk.batched_rss(b, b, g, g, n_valid=n_valid)
    with pytest.raises(exc):
        tk.batched_rss_ref(b, b, g, g, n_valid=n_valid)


@pytest.mark.parametrize("n", [16_384, 100_000])
def test_sweep_log_densities_against_pmpx(n):
    """The sweep, which reads the real points only, at the tolerances of
    tests/test_torch_linreg.py: pmpx's float64-statistics "suffstats" at
    rtol 1e-5, pmpx's f32 sweep ("xla") at rtol 3e-4, float64 at rtol
    1e-5."""
    x, y = _data(n, 6)
    Theta = (np.random.default_rng(n).normal(size=(64, 3)) * 0.3
             + [-1.0, 2.0, 0.5]).astype(np.float32)
    tt = linreg_from_numpy(x, y, temper=0.05, method="sweep", device="cpu")
    got = tt.log_prob_batch(torch.tensor(Theta)).numpy()
    for jmethod, rtol in (("suffstats", 1e-5), ("xla", 3e-4)):
        jt = jlin.BayesLinReg(jnp.asarray(x), jnp.asarray(y), temper=0.05,
                              method=jmethod)
        np.testing.assert_allclose(
            got, _np(jt.log_prob_batch(jnp.asarray(Theta))), rtol=rtol)
    X, Y, T = (a.astype(np.float64) for a in (x, y, Theta))
    rss = ((Y[None] - T[:, :1] - T[:, 1:2] * X[None]) ** 2).sum(1)
    s2 = T[:, 2] ** 2
    exact = 0.05 * (-0.5 * n * (np.log(2 * np.pi) + np.log(s2))
                    - rss / (2 * s2))
    np.testing.assert_allclose(got, exact, rtol=1e-5)
