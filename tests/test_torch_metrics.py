"""The port's metrics (``pmpx_torch.metrics``: ess, mixing, analysis)
against pmpx's on the same NumPy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pmpx import metrics as jm  # noqa: E402
from pmpx_torch import metrics as tm  # noqa: E402


def _ar1(n, phi, seed, d=None):
    """A seeded AR(1) series (n,) or (n, d) with coefficient phi, f32."""
    rng = np.random.default_rng(seed)
    shape = (n,) if d is None else (n, d)
    e = rng.standard_normal(shape)
    x = np.zeros(shape)
    for t in range(1, n):
        x[t] = phi * x[t - 1] + e[t]
    return x.astype(np.float32)


def _geyer_margin(x):
    """The Geyer pair sums of x in float64 up to the first non-positive
    one, and that index: the test series keep every such pair, and the
    pair that stops the sum, well away from 0, so that f32 rounding in
    either package cannot move the truncation."""
    acov = jm.autocov_chunked(x, len(x) - 1)
    rho = acov / acov[0]
    pairs = rho[: 2 * (len(x) // 2)].reshape(-1, 2).sum(1)
    k = int(np.nonzero(pairs <= 0)[0][0])
    return np.abs(pairs[:k + 1]).min(), k


# ESS series: AR(1) coefficients and seeds where no Geyer pair sits
# within 1e-3 of 0 (checked in each test)
ESS_SERIES = [(0.5, 1), (0.8, 2), (0.9, 5), (0.3, 4)]


@pytest.mark.parametrize("phi,seed", ESS_SERIES)
def test_autocov_matches_pmpx(phi, seed):
    # rtol 1e-5, atol 1e-5 of the variance: both are f32 FFTs of the same
    # length, whose rounding is relative to the largest lag
    x = _ar1(3000, phi, seed)
    want = np.asarray(jm.autocov(jnp.asarray(x)))
    got = tm.autocov(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (3000,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * want[0])


@pytest.mark.parametrize("phi,seed", ESS_SERIES)
def test_ess_matches_pmpx(phi, seed):
    # rtol 1e-4: the same Geyer truncation index (no pair near 0), and
    # f32 sums of up to a few hundred autocorrelations
    x = _ar1(4000, phi, seed)
    margin, k = _geyer_margin(x)
    assert margin > 1e-3, (margin, k)
    want = float(jm.ess(jnp.asarray(x)))
    got = tm.ess(torch.tensor(x))
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-4)
    # and the float64 host estimator, on the same series
    np.testing.assert_allclose(
        float(tm.ess(torch.tensor(x, dtype=torch.float64))),
        tm.ess_chunked(x, max_lag=64), rtol=1e-8)


def test_ess_per_dim_matches_pmpx():
    # five columns of different mixing, one batched FFT; rtol 1e-4 as ess
    X = np.stack([_ar1(4000, phi, seed) for phi, seed in ESS_SERIES]
                 + [_ar1(4000, 0.0, 9)], axis=1)
    for j in range(X.shape[1]):
        assert _geyer_margin(X[:, j])[0] > 1e-3, j
    want = np.asarray(jm.ess_per_dim(jnp.asarray(X)))
    got = tm.ess_per_dim(torch.tensor(X)).numpy()
    assert got.shape == want.shape == (5,)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for j in range(X.shape[1]):  # batched == one column at a time
        np.testing.assert_allclose(
            got[j], float(tm.ess(torch.tensor(X[:, j]))), rtol=1e-6)


def test_ess_edge_cases_match_pmpx():
    """A constant series (variance 0) and white noise (ESS clipped at n)."""
    for x in (np.full(256, 2.0, np.float32),
              np.random.default_rng(0).standard_normal(257).astype(
                  np.float32)):
        want = float(jm.ess(jnp.asarray(x)))
        got = float(tm.ess(torch.tensor(x)))
        np.testing.assert_allclose(got, want, rtol=1e-4)
        assert got <= len(x)


@pytest.mark.parametrize("chains,n,shift", [(4, 1000, 0.0), (3, 601, 0.5)])
def test_split_rhat_matches_pmpx(chains, n, shift):
    # rtol 1e-5: means and variances of ~1000 f32 values
    X = np.stack([_ar1(n, 0.6, 10 + c) + shift * c for c in range(chains)])
    want = float(jm.split_rhat(jnp.asarray(X)))
    got = float(tm.split_rhat(torch.tensor(X)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (got > 1.05) == (shift > 0)


@pytest.mark.parametrize("max_lag,block", [(64, 1 << 16), (16, 500),
                                           (4096, 1000)])
def test_chunked_estimators_match_pmpx(max_lag, block):
    # float64 NumPy on both sides, the same algorithm: to 1e-10
    x = _ar1(5000, 0.9, 7)
    np.testing.assert_allclose(
        tm.autocov_chunked(x, max_lag, block=block),
        jm.autocov_chunked(x, max_lag, block=block), rtol=1e-10,
        atol=1e-12)
    np.testing.assert_allclose(
        tm.ess_chunked(x, max_lag=max_lag, block=block),
        jm.ess_chunked(x, max_lag=max_lag, block=block), rtol=1e-10)


def test_mixing_metrics_match_pmpx():
    # rtol 1e-5: f32 means over a few thousand values
    rng = np.random.default_rng(3)
    X = np.cumsum(rng.standard_normal((2000, 3)), 0).astype(np.float32)
    X[100:110] = X[99]  # ten steps that stay put
    tX = torch.tensor(X)
    np.testing.assert_allclose(float(tm.msjd(tX)),
                               float(jm.msjd(jnp.asarray(X))), rtol=1e-5)
    np.testing.assert_allclose(float(tm.move_rate(tX)),
                               float(jm.move_rate(jnp.asarray(X))),
                               rtol=1e-6)
    assert float(tm.move_rate(tX)) == pytest.approx(1 - 10 / 1999)
    S = rng.gamma(2.0, size=(500, 4)).astype(np.float32)
    np.testing.assert_allclose(float(tm.skewness(torch.tensor(S))),
                               float(jm.skewness(jnp.asarray(S))),
                               rtol=1e-5)
    for axis in (0, 1):
        np.testing.assert_allclose(
            tm.skewness(torch.tensor(S), axis=axis).numpy(),
            np.asarray(jm.skewness(jnp.asarray(S), axis=axis)), rtol=1e-5,
            atol=1e-6)


def test_analysis_matches_pmpx():
    """The port's own copy of the NumPy/SciPy module gives pmpx's
    numbers on the same loss traces."""
    rng = np.random.default_rng(5)
    t = np.arange(3000)
    slow = np.exp(-t / 900.0) + 0.01 * rng.standard_normal(3000)
    fast = np.exp(-t / 400.0) + 0.01 * rng.standard_normal(3000)
    np.testing.assert_allclose(tm.smooth_loss(slow), jm.smooth_loss(slow),
                               rtol=1e-12)
    np.testing.assert_allclose(tm.smooth_loss(slow[:4]),
                               jm.smooth_loss(slow[:4]))
    th = [0.8, 0.5, 0.2, -1.0]
    np.testing.assert_array_equal(tm.first_crossing(slow, th),
                                  jm.first_crossing(slow, th))
    s_t, cf_t, cb_t = tm.iteration_speedup(fast, slow)
    s_j, cf_j, cb_j = jm.iteration_speedup(fast, slow)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-12)
    np.testing.assert_array_equal(cf_t, cf_j)
    np.testing.assert_array_equal(cb_t, cb_j)
    assert 2.0 < s_t < 2.6  # 900 / 400, the fast trace's speedup
