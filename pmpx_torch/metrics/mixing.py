"""Mixing-quality metrics: MSJD, skewness, move rate (port of
``pmpx/metrics/mixing.py``).

* MSJD — mean squared jump distance, the quantity behind the reference's
  ``msjd_compare.pdf``.
* skewness — the reference's unbiasedness-vs-iterations diagnostic
  (``simple_net/skewness/skewness.ipynb`` cell 1: the standardized third
  moment of the chain mean estimates).
* move rate — fraction of supersteps whose selected root differs from the
  incumbent (the SP acceptance rate's analog for tree samplers).
"""

from __future__ import annotations

import torch

__all__ = ["msjd", "skewness", "move_rate"]


def msjd(X: torch.Tensor) -> torch.Tensor:
    """Mean squared jump distance of an (n, d) chain."""
    d = X[1:] - X[:-1]
    return torch.mean(torch.sum(d * d, dim=-1))


def skewness(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Standardized third central moment (biased, like the notebook's)."""
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    mu = x.mean(dim=axis, keepdim=True)
    s = x.std(dim=axis, correction=0, keepdim=True)
    z = (x - mu) / torch.clamp(s, min=1e-30)
    return torch.mean(z**3, dim=axis)


def move_rate(roots: torch.Tensor) -> torch.Tensor:
    """Fraction of steps where the chain moved: ``roots`` (steps, d),
    counting steps with any coordinate changed (the analog of SP
    acceptance counting, ``error.py:34-38``)."""
    moved = torch.any(roots[1:] != roots[:-1], dim=-1)
    return moved.to(torch.float32).mean()
