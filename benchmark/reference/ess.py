"""Effective sample size by Geyer's initial positive sequence (Geyer 1992),
a frozen copy of ``pmpx_torch/metrics/ess.py``'s estimator, so that no
change to the program moves the yardstick.

The autocovariance comes from a zero-padded FFT (to at least 2n) of each
column in float64, on the series' device, a group of columns at a time so
that the transient stays under ``max_bytes``.
"""

from __future__ import annotations

import torch

__all__ = ["ess_columns"]


def _autocov(X: torch.Tensor) -> torch.Tensor:
    """Biased autocovariance at all lags along dim 0 of (n, k)."""
    n = X.shape[0]
    xc = X - X.mean(dim=0, keepdim=True)
    nfft = 2 ** (2 * n - 1).bit_length()
    f = torch.fft.rfft(xc, nfft, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), nfft, dim=0)[:n]
    return acov / n


def _geyer(acov: torch.Tensor, n: int) -> torch.Tensor:
    """ESS from autocovariances (dim 0 the lag): adjacent autocorrelation
    pairs are summed while every pair so far is positive; ESS = n / (-1 +
    2 * that sum), clipped to at most n."""
    rho = acov / torch.clamp(acov[0], min=1e-300)
    n_pairs = n // 2
    pairs = rho[: 2 * n_pairs].reshape(n_pairs, 2, *rho.shape[1:]).sum(1)
    keep = torch.cumprod((pairs > 0.0).to(rho.dtype), dim=0)
    tau = -1.0 + 2.0 * torch.sum(pairs * keep, dim=0)
    tau = torch.clamp(tau, min=1.0 / n)
    return torch.clamp(n / tau, max=1.0 * n)


def ess_columns(X: torch.Tensor, max_bytes: int = 2 << 30) -> torch.Tensor:
    """ESS of each column of ``X`` (n, k), in float64.  A column with no
    variance has ESS NaN: it says nothing of mixing."""
    X = X.double()
    n, k = X.shape
    nfft = 2 ** (2 * n - 1).bit_length()
    group = max(1, int(max_bytes // (nfft * 16 * 3)))
    out = []
    for s in range(0, k, group):
        cols = X[:, s:s + group]
        e = _geyer(_autocov(cols), n)
        flat = cols.var(dim=0) == 0
        out.append(torch.where(flat, torch.full_like(e, float("nan")), e))
    return torch.cat(out)
