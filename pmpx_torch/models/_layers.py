"""Layers with flax's parameter layout and dtype promotion."""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["Dense", "dense"]


def dense(x: torch.Tensor, kernel: torch.Tensor,
          bias: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ kernel + bias`` in the promoted type of the three, as
    ``flax.linen.Dense`` promotes them (a float32 input and a bfloat16
    kernel compute in float32)."""
    dt = torch.promote_types(x.dtype, kernel.dtype)
    if bias is not None:
        dt = torch.promote_types(dt, bias.dtype)
    y = x.to(dt) @ kernel.to(dt)
    return y if bias is None else y + bias.to(dt)


class Dense(nn.Module):
    """``flax.linen.Dense``'s parameters: ``kernel`` (in, out) and
    ``bias`` (out).  Their values come from the posterior's theta through
    ``torch.func.functional_call``; the module's own are zeros."""

    def __init__(self, d_in: int, d_out: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(d_out)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.kernel, self.bias)
