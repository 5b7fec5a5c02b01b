"""Bayesian linear regression target: y = beta0 + beta1*x + sigma*eps (port
of ``pmpx/targets/linreg.py``).

State is theta = (beta0, beta1, sigma); the likelihood uses sigma**2.
Three exact evaluation strategies:

* ``"sweep"`` — the O(P*n) data sweep over the n real points (the zero
  padding is never read, so nothing is subtracted for it): the CUDA kernel
  of ``pmpx_torch.kernels.linreg`` on the card, its plain version on the
  CPU (``pmpx``'s ``"pallas"``/``"xla"``, which the port takes as names of
  ``"sweep"``);
* ``"fused"`` — the five sufficient statistics recomputed in f32 from the
  padded data on every call, then O(P);
* ``"suffstats"`` — the statistics computed once, in float64, at
  construction.
"""

from __future__ import annotations

import math

import torch

from pmpx_torch._device import resolve_device
from pmpx_torch.kernels import linreg as _k

__all__ = ["BayesLinReg", "loglik_from_rss", "make_synthetic_linreg",
           "pad_to_grid"]

_LOG_2PI = math.log(2.0 * math.pi)
_LANES = 128


def _f32(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.tensor(a, dtype=torch.float32, device=device)


def make_synthetic_linreg(
    generator: torch.Generator,
    n: int,
    beta0: float = -1.0,
    beta1: float = 2.0,
    sigma: float = 0.5,
):
    """Synthetic dataset with the reference's generative parameters:
    x ~ U(-1, 1), y = beta0 + beta1*x + sigma*N(0, 1), drawn on the
    generator's device.  The data stream differs from ``pmpx``'s
    ``jax.random`` one for the same seed: tests that compare the two
    packages pass the same NumPy data to both."""
    dev = generator.device
    x = 2.0 * torch.rand((n,), generator=generator, device=dev) - 1.0
    noise = torch.randn((n,), generator=generator, device=dev)
    y = beta0 + beta1 * x + sigma * noise
    return x, y


def pad_to_grid(x: torch.Tensor, row_mult: int = 128) -> torch.Tensor:
    """Pad a 1-D array with zeros to a (rows, 128) lane-major grid, rows a
    multiple of ``row_mult``."""
    n = x.shape[0]
    per_blk = row_mult * _LANES
    n_pad = ((n + per_blk - 1) // per_blk) * per_blk
    xp = torch.zeros((n_pad,), dtype=torch.float32, device=x.device)
    xp[:n] = x
    return xp.reshape(n_pad // _LANES, _LANES)


def loglik_from_rss(rss, sigma, n: int, temper: float) -> torch.Tensor:
    """The tempered Gaussian log-likelihood of n points from their RSS."""
    s2 = torch.clamp(sigma * sigma, min=1e-30)
    return temper * (-0.5 * n * (_LOG_2PI + torch.log(s2)) - rss / (2.0 * s2))


class BayesLinReg:
    """theta = (beta0, beta1, sigma); log-lik tempered by ``temper``.

    ``x``, ``y`` are moved to ``device`` (CUDA unless the caller names
    another).
    """

    d = 3

    def __init__(
        self,
        x,
        y,
        temper: float = 1.0,
        method: str = "auto",
        device=None,
    ):
        if method == "auto":
            method = "fused"
        if method in ("pallas", "xla"):
            method = "sweep"  # pmpx's names of its two sweeps
        if method not in ("sweep", "fused", "suffstats"):
            raise ValueError(f"unknown linreg method {method!r}")
        self.method = method
        self.temper = float(temper)
        self.device = resolve_device(device)
        self.x = _f32(x, self.device)
        self.y = _f32(y, self.device)
        self.n = int(self.x.shape[0])
        # padded lane-major layout; the sweep reads the first n points only
        self.x2d = pad_to_grid(self.x)
        self.y2d = pad_to_grid(self.y)
        xh = self.x.double()
        yh = self.y.double()
        self.stats = torch.stack(
            [
                xh.sum(),
                yh.sum(),
                (xh * xh).sum(),
                (yh * yh).sum(),
                (xh * yh).sum(),
            ]
        ).float()

    # -- rss strategies ----------------------------------------------------
    def _rss_from_stats(self, b0, b1, stats):
        sx, sy, sxx, syy, sxy = stats
        return (
            syy
            + self.n * b0 * b0
            + b1 * b1 * sxx
            + 2.0 * b0 * b1 * sx
            - 2.0 * b0 * sy
            - 2.0 * b1 * sxy
        )

    def _rss(self, b0, b1):
        if self.method == "sweep":
            return _k.batched_rss(b0, b1, self.x2d, self.y2d, n_valid=self.n)
        if self.method == "fused":
            x, y = self.x2d, self.y2d
            stats = (
                torch.sum(x),
                torch.sum(y),
                torch.sum(x * x),
                torch.sum(y * y),
                torch.sum(x * y),
            )
            return self._rss_from_stats(b0, b1, stats)
        return self._rss_from_stats(b0, b1, self.stats)

    def _loglik_from_rss(self, rss, sigma):
        return loglik_from_rss(rss, sigma, self.n, self.temper)

    def _rss_padded(self, b0, b1):
        """RSS handling the sweep kernel's proposal-padding contract."""
        if self.method != "sweep":
            return self._rss(b0, b1)
        b0p, b1p, P = _k.pad_proposals(b0, b1)
        return self._rss(b0p.contiguous(), b1p.contiguous())[:P]

    # -- Target protocol ---------------------------------------------------
    def log_prob(self, theta):
        return self.log_prob_batch(theta[None, :])[0]

    def value_and_grad_batch(self, Theta):
        """(log-lik, gradient), the gradient closed-form in the five
        sufficient statistics (the sweep kernel has no backward)."""
        b0, b1, sigma = Theta[:, 0], Theta[:, 1], Theta[:, 2]
        rss = self._rss_padded(b0, b1)
        vals = self._loglik_from_rss(rss, sigma)
        sx, sy, sxx, _, sxy = self.stats
        sig = torch.where(
            torch.abs(sigma) < 1e-15, torch.full_like(sigma, 1e-15), sigma
        )
        s2 = sig * sig
        drss_db0 = 2.0 * (self.n * b0 + b1 * sx - sy)
        drss_db1 = 2.0 * (b0 * sx + b1 * sxx - sxy)
        g0 = -self.temper * drss_db0 / (2.0 * s2)
        g1 = -self.temper * drss_db1 / (2.0 * s2)
        g2 = self.temper * (-self.n / sig + rss / (sig * s2))
        return vals, torch.stack([g0, g1, g2], dim=-1)

    def log_prob_batch(self, Theta):
        b0, b1, sigma = Theta[:, 0], Theta[:, 1], Theta[:, 2]
        rss = self._rss_padded(b0, b1)
        return self._loglik_from_rss(rss, sigma)
