"""Effective sample size and autocorrelation diagnostics (port of
``pmpx/metrics/ess.py``).

The reference's ESS/s and MSJD/s figures came from million-step sample
dumps analysed by offline code that is not in its repository; this module
supplies that computation, on the tensor's device:

* autocovariance via FFT (O(n log n)), zero-padded to at least 2n;
* ESS with Geyer's initial-positive-sequence truncation (Geyer 1992);
* split-R-hat (Gelman-Rubin) over several chains.

``autocov_chunked`` and ``ess_chunked`` are the host (NumPy, float64)
estimators for long streams, as in ``pmpx``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "autocov", "ess", "ess_per_dim", "split_rhat",
    "autocov_chunked", "ess_chunked",
]


def _autocov(X: torch.Tensor) -> torch.Tensor:
    """Biased autocovariance at all lags along dim 0 of (n, ...)."""
    n = X.shape[0]
    xc = X - X.mean(dim=0, keepdim=True)
    nfft = 2 ** (2 * n - 1).bit_length()  # next pow2 >= 2n (zero padding)
    f = torch.fft.rfft(xc, nfft, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), nfft, dim=0)[:n]
    return acov / n


def _geyer_ess(acov: torch.Tensor, n: int) -> torch.Tensor:
    """ESS from the autocovariances (dim 0 the lag): sum adjacent
    autocorrelation pairs while every pair so far is positive; ESS =
    n / (-1 + 2 * that sum), clipped to [.., n]."""
    rho = acov / torch.clamp(acov[0], min=1e-30)
    n_pairs = n // 2
    pairs = rho[: 2 * n_pairs].reshape(n_pairs, 2, *rho.shape[1:]).sum(1)
    keep = torch.cumprod((pairs > 0.0).to(rho.dtype), dim=0)
    tau = -1.0 + 2.0 * torch.sum(pairs * keep, dim=0)
    tau = torch.clamp(tau, min=1.0 / n)
    return torch.clamp(n / tau, max=1.0 * n)


def autocov(x: torch.Tensor) -> torch.Tensor:
    """Autocovariance of a 1-D series at all lags (biased, FFT-based)."""
    return _autocov(x)


def ess(x: torch.Tensor) -> torch.Tensor:
    """Effective sample size of a 1-D chain via Geyer pairing (0-d)."""
    return _geyer_ess(_autocov(x), x.shape[0])


def ess_per_dim(X: torch.Tensor) -> torch.Tensor:
    """ESS of each column of an (n, d) sample matrix, all columns in one
    batched FFT."""
    return _geyer_ess(_autocov(X), X.shape[0])


def split_rhat(X: torch.Tensor) -> torch.Tensor:
    """Split-R-hat over (chains, n) draws of one scalar quantity."""
    c, n = X.shape
    half = n // 2
    halves = torch.cat([X[:, :half], X[:, half: 2 * half]], dim=0)
    m, l = halves.shape
    chain_means = halves.mean(dim=1)
    chain_vars = halves.var(dim=1, correction=1)
    B = l * chain_means.var(correction=1)
    W = chain_vars.mean()
    var_plus = (l - 1) / l * W + B / l
    return torch.sqrt(var_plus / torch.clamp(W, min=1e-30))


def autocov_chunked(x, max_lag: int, block: int = 1 << 16):
    """Biased autocovariance up to ``max_lag``, memory-bounded (NumPy,
    float64).

    :func:`autocov` pads to a 2n FFT, a large transient per long stream
    when an analysis sweeps hundreds of them.  MCMC chains only need lags
    up to the Geyer truncation point (<< n), so this computes the same
    biased autocov for lags [0, max_lag] by overlap-save: per block of
    size B, ``c[l] = sum_i xc[s:s+B][i] * xc[s:s+B+L][i+l]`` via one
    (B+L)-point FFT pair, summed over blocks.  Peak transient is
    O(block + max_lag), independent of n.
    """
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    L = int(min(max_lag, n - 1))
    xc = x - x.mean()
    B = int(max(block, L + 1))
    nfft = 1 << (B + L).bit_length()
    acc = np.zeros(L + 1)
    for s in range(0, n, B):
        a = xc[s:s + B]
        b = xc[s:s + B + L]
        fa = np.fft.rfft(a, nfft)
        fb = np.fft.rfft(b, nfft)
        acc += np.fft.irfft(np.conj(fa) * fb, nfft)[: L + 1]
    return acc / n


def ess_chunked(x, max_lag: int = 4096, block: int = 1 << 16) -> float:
    """Geyer ESS identical to :func:`ess`, with bounded memory (NumPy,
    float64).

    Starts from ``max_lag`` and doubles until the initial-positive-
    sequence truncation point falls inside the window (or the window
    reaches n), so the result matches the full-FFT :func:`ess` to float
    tolerance while never materializing a 2n-padded spectrum.
    """
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    L = int(min(max_lag, n - 1))
    while True:
        acov = autocov_chunked(x, L, block=block)
        rho = acov / max(acov[0], 1e-30)
        n_pairs = min(len(rho) // 2, n // 2)
        pairs = rho[: 2 * n_pairs].reshape(n_pairs, 2).sum(axis=1)
        nonpos = np.nonzero(pairs <= 0.0)[0]
        if len(nonpos) or L >= n - 1:
            k = nonpos[0] if len(nonpos) else n_pairs
            tau = -1.0 + 2.0 * float(pairs[:k].sum())
            tau = max(tau, 1.0 / n)
            return float(min(n / tau, float(n)))
        L = int(min(2 * L, n - 1))
