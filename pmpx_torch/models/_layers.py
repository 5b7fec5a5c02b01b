"""Layers with flax's parameter layout and dtype promotion."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["BatchNorm", "Conv", "Dense", "batch_norm", "conv_flax", "dense",
           "flax_layout", "max_pool2"]


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


def conv_flax(x: torch.Tensor, kernel: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """``flax.linen.Conv`` with VALID padding on an NCHW input: ``kernel``
    in flax's (kh, kw, in, out) layout, promoted as flax promotes."""
    dt = torch.promote_types(torch.promote_types(x.dtype, kernel.dtype),
                             bias.dtype)
    w = kernel.to(dt).permute(3, 2, 0, 1)  # (out, in, kh, kw)
    return F.conv2d(x.to(dt), w, bias.to(dt))


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5, group=None) -> torch.Tensor:
    """``flax.linen.BatchNorm(use_running_average=False)`` over the batch
    and spatial axes of an NCHW tensor, with flax's fast variance E[x^2] -
    E[x]^2 (clamped at 0) in float32.  No running statistics: the
    posterior always normalises by the batch at hand, and this form runs
    under ``torch.func.vmap``.

    ``group``: sync-BN over the ranks of a process group (the data axis of
    a mesh), as flax's ``axis_name``: the local E[x] and E[x^2] are
    averaged over the group in one collective
    (:func:`pmpx_torch.parallel.mesh.psum` of their concatenation, over
    the group's size), and the clamp comes after.  The average is the
    global one only where every rank holds a shard of the same size, as
    flax's ``pmean`` assumes."""
    dims = (0, 2, 3)
    xf = x.float()
    mean = xf.mean(dim=dims)
    mean2 = (xf * xf).mean(dim=dims)
    if group is not None:
        from pmpx_torch.parallel.mesh import psum

        stats = psum(torch.cat([mean, mean2]), group) / group.size()
        mean, mean2 = stats.chunk(2)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * scale.float()
    y = (xf - mean[:, None, None]) * mul[:, None, None] + bias.float()[
        :, None, None]
    return y.to(torch.promote_types(x.dtype, scale.dtype))


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """``flax.linen.max_pool(x, (2, 2), strides=(2, 2))`` on NCHW, as a
    max over reshaped windows: its backward is elementwise (no atomics, so
    deterministic on a card), and it differs from a max-pool's gradient
    only where a window ties, which after a ReLU happens only at 0, where
    the gradient is 0 either way."""
    B, C, H, W = x.shape
    x = x[:, :, : H // 2 * 2, : W // 2 * 2]
    return x.reshape(B, C, H // 2, 2, W // 2, 2).amax(dim=(3, 5))


def flax_layout(model: nn.Module) -> list:
    """(flax path, shape, initialiser) of every leaf of a model built from
    these layers, in the order of ``ravel_pytree`` over flax's tree: sorted
    module names, sorted leaf names; kernels lecun-normal, biases zeros,
    BatchNorm scales ones (flax's defaults)."""
    out = []
    for name, mod in sorted(model.named_children()):
        for leaf, p in sorted(mod.named_parameters()):
            init = {"bias": "zeros", "scale": "ones"}.get(leaf, "lecun_normal")
            out.append((f"{name}.{leaf}", tuple(p.shape), init))
    return out


class Conv(nn.Module):
    """``flax.linen.Conv``'s parameters: ``kernel`` (kh, kw, in, out) and
    ``bias`` (out)."""

    def __init__(self, c_in: int, c_out: int, k: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(k, k, c_in, c_out))
        self.bias = nn.Parameter(torch.zeros(c_out))


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm``'s parameters: ``scale`` and ``bias``; no
    buffers (nothing but parameters enters theta)."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
