"""Analytic sampling targets (port of ``pmpx/targets/analytic.py``).

* ``Gaussian1D`` — the error-boxplot target N(mu, sigma)
  (``simple_sampling/error/error.py:11-14,191-201``).
* ``StandardMVN`` — d-dimensional standard normal, the correlation-sweep
  target (``complex_nets/correlation/com_dim.py:13-15,99-104``).
* ``Banana`` — 2-D banana density
  ``exp(-x1^2/2) * exp(-(x2 - b*(x1^2 - a))^2/2)`` with the reference's
  a=5, b=2 (``simple_sampling/error/banana/banana_data.ipynb`` cell 2).
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["Gaussian1D", "StandardMVN", "Banana"]

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class Gaussian1D:
    mu: float = 0.0
    sigma: float = 1.0
    d: int = 1

    def log_prob(self, theta):
        z = (theta[0] - self.mu) / self.sigma
        return -0.5 * (_LOG_2PI + z * z) - math.log(self.sigma)

    def log_prob_batch(self, Theta):
        z = (Theta[:, 0] - self.mu) / self.sigma
        return -0.5 * (_LOG_2PI + z * z) - math.log(self.sigma)


@dataclasses.dataclass(frozen=True)
class StandardMVN:
    d: int = 2

    def log_prob(self, theta):
        return -0.5 * (self.d * _LOG_2PI + torch.sum(theta * theta))

    def log_prob_batch(self, Theta):
        return -0.5 * (
            self.d * _LOG_2PI + torch.sum(Theta * Theta, dim=-1)
        )


@dataclasses.dataclass(frozen=True)
class Banana:
    a: float = 5.0
    b: float = 2.0
    d: int = 2

    def log_prob(self, theta):
        x1, x2 = theta[0], theta[1]
        t = x2 - self.b * (x1 * x1 - self.a)
        return -0.5 * (x1 * x1 + t * t)

    def log_prob_batch(self, Theta):
        x1, x2 = Theta[:, 0], Theta[:, 1]
        t = x2 - self.b * (x1 * x1 - self.a)
        return -0.5 * (x1 * x1 + t * t)
