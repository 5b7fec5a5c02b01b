"""On-device categorical resampling (port of ``pmpx/resample.py``).

Both draws are the inverse-CDF count, so a test can inject the uniforms
that ``pmpx`` drew and replay its choice exactly.  (``pmpx.resample.
categorical`` uses Gumbel-max instead; the law is the same.)  Leading axes
of ``logits`` are a batch of chains, each drawing from its own row.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["categorical", "categorical_many"]


def categorical_many(
    logits: torch.Tensor,
    num: int,
    *,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``num`` iid draws from unnormalized ``logits`` (..., P) via inverse
    CDF, per row.

    idx_i = #{j : u_i > cdf_j}, with cdf the cumulative sum of
    softmax(logits) divided by its last entry, clipped to P-1, int32.
    ``u`` (..., num) replaces the uniforms drawn from ``generator``.
    """
    p = torch.softmax(logits, dim=-1)
    cdf = torch.cumsum(p, dim=-1)
    cdf = cdf / cdf[..., -1:]  # exact normalization against fp drift
    if u is None:
        u = torch.rand(
            logits.shape[:-1] + (num,), generator=generator,
            device=logits.device, dtype=logits.dtype,
        )
    idx = torch.sum(u[..., :, None] > cdf[..., None, :], dim=-1)
    return torch.clamp(idx, 0, logits.shape[-1] - 1).to(torch.int32)


def categorical(
    logits: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One draw from unnormalized logits (..., P): an int32 tensor of the
    batch's shape (0-d for one chain)."""
    return categorical_many(logits, 1, generator=generator, u=u)[..., 0]
