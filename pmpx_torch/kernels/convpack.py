"""Channel-packed conv layout for small-channel convs (port of
``pmpx/kernels/convpack.py``).

``pmpx`` measured this layout as a negative result against its native
NHWC convolutions (``pmpx/models/packed.py``); it is ported so that the
port does all ``pmpx`` does, and its cost on the card is measured by
``pmpx_torch.experiments.nn_perf`` (PERF.md §6).

Activations live as ``(B, C, H*Wr)``: channels, then the flattened
spatial grid.  A convolution is KH*KW shifted *contiguous* slices of the
flat spatial axis, each contracted against a (C, O) kernel slab: no
gathers, no im2col, no dynamic shapes.  The products are cuBLAS's
(``torch.matmul``); there is no hand-written kernel here, and none in
``pmpx``'s counterpart.

The "wide rows" trick: a VALID conv shrinks the row width W -> W-KW+1,
which would break the contiguous-slice identity ``in_flat[q + dy*Wr +
dx]`` (input and output rows must share one physical width ``Wr``).  So
rows keep their physical width and the last ``Wr - W`` columns of each
row hold junk (finite garbage computed across row boundaries).  Junk never
reaches a valid output: a valid output column x < W reads input columns
x+dx <= W-1+KW-1 = W_in-1, all valid; pooling with even widths keeps junk
columns aligned to junk columns.  BatchNorm's statistics mask junk
explicitly.

Everything is plain slices and products, so ``torch.func.vmap`` (the
proposal axis) and autodiff compose.  ``conv2d(remat=True)`` takes the
KH*KW slices again in the backward pass instead of saving them, through a
``torch.autograd.Function`` with a vmap rule and its own backward
(``torch.utils.checkpoint`` does not run under ``torch.func.grad``).
``batchnorm``'s ``axis_name`` is sync-BN over a process group (the data
axis of a mesh), through :func:`pmpx_torch.parallel.mesh.psum`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

__all__ = [
    "Grid",
    "pack_images",
    "unpack",
    "valid_mask",
    "conv2d",
    "batchnorm",
    "max_pool2",
]


@dataclass(frozen=True)
class Grid:
    """Static shape metadata for a wide-row packed activation.

    h: number of rows; wr: physical row width (lanes per row);
    w: valid columns per row (w <= wr; columns [w, wr) are junk).
    """

    h: int
    wr: int
    w: int

    @property
    def size(self) -> int:
        return self.h * self.wr


def pack_images(x: torch.Tensor) -> tuple[torch.Tensor, Grid]:
    """(B, H, W[, C]) NHWC image batch -> ((B, C, H*W), Grid)."""
    if x.ndim == 3:
        x = x[..., None]
    B, H, W, C = x.shape
    packed = x.permute(0, 3, 1, 2).reshape(B, C, H * W)
    return packed, Grid(H, W, W)


def unpack(x: torch.Tensor, g: Grid) -> torch.Tensor:
    """(B, C, H*Wr) packed -> (B, H, W, C) NHWC with junk columns dropped."""
    B, C, _ = x.shape
    return x.reshape(B, C, g.h, g.wr)[..., : g.w].permute(0, 2, 3, 1)


def valid_mask(g: Grid, dtype=torch.float32, device=None) -> torch.Tensor:
    """(H*Wr,) 1.0 on valid columns, 0.0 on junk."""
    cols = torch.arange(g.wr, device=device) < g.w
    return cols.expand(g.h, g.wr).reshape(-1).to(dtype)


def _conv2d_body(x, kernel, bias, g: Grid):
    KH, KW, C, O = kernel.shape
    oh = g.h - KH + 1
    out_len = oh * g.wr
    # the largest slice ends at (KH-1)*wr + (KW-1) + out_len = h*wr + KW-1
    xp = F.pad(x, (0, KW - 1))
    out = bias[None, :, None].to(x.dtype).expand(x.shape[0], O, out_len)
    for dy in range(KH):
        for dx in range(KW):
            off = dy * g.wr + dx
            xs = xp[:, :, off:off + out_len]
            # (O, C) @ (B, C, L) -> (B, O, L): cross-correlation, as flax's
            # nn.Conv (HWIO kernel, no flip)
            out = out + torch.matmul(kernel[dy, dx].T, xs)
    return out


def _conv2d_grads(x, kernel, gout, g: Grid, need_x: bool, need_k: bool):
    """The gradients of ``_conv2d_body`` with respect to x and the kernel,
    tap by tap from the shifted slices of x (recomputed, never saved):
    the kernel's tap (dy, dx) gets sum_b,l xs[b, c, l] gout[b, o, l], and
    x gets each tap's (C, O) @ gout placed back at the tap's offset."""
    KH, KW, C, O = kernel.shape
    L = gout.shape[-1]
    Lp = x.shape[-1] + KW - 1
    xp = F.pad(x, (0, KW - 1)) if need_k else None
    gx, gk = None, []
    for dy in range(KH):
        for dx in range(KW):
            off = dy * g.wr + dx
            if need_k:
                gk.append(torch.einsum("bcl,bol->co",
                                       xp[:, :, off:off + L], gout))
            if need_x:
                t = F.pad(torch.matmul(kernel[dy, dx], gout),
                          (off, Lp - off - L))
                gx = t if gx is None else gx + t
    if need_x:
        gx = gx[..., :x.shape[-1]]
    if need_k:
        gk = torch.stack(gk).reshape(KH, KW, C, O)
    return gx, (gk if need_k else None)


class _RematConv(torch.autograd.Function):
    """``_conv2d_body`` that saves only its inputs: the backward pass
    forms each tap's gradient from a slice of x taken again
    (:func:`_conv2d_grads`), so no KH*KW copies of x are kept.  It has a
    vmap rule, so ``torch.func.vmap`` of ``grad`` runs through it."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, kernel, bias, g):
        with torch.no_grad():
            return _conv2d_body(x, kernel, bias, g)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, kernel, _, g = inputs
        ctx.save_for_backward(x, kernel)
        ctx.grid = g

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        x, kernel = ctx.saved_tensors
        need_x, need_k, need_b = ctx.needs_input_grad[:3]
        gx, gk = _conv2d_grads(x, kernel, gout, ctx.grid, need_x, need_k)
        gb = gout.sum(dim=(0, 2)) if need_b else None
        return gx, gk, gb, None


def conv2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    g: Grid,
    remat: bool = True,
) -> tuple[torch.Tensor, Grid]:
    """VALID cross-correlation in packed layout.

    x: (B, C, h*wr); kernel: (KH, KW, C, O) (flax HWIO); bias: (O,).
    Returns ((B, O, oh*wr), Grid(oh, wr, ow)).
    """
    KH, KW, _, _ = kernel.shape
    if remat:
        out = _RematConv.apply(x, kernel, bias, g)
    else:
        out = _conv2d_body(x, kernel, bias, g)
    return out, Grid(g.h - KH + 1, g.wr, g.w - KW + 1)


def batchnorm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    g: Grid,
    eps: float = 1e-5,
    axis_name=None,
) -> torch.Tensor:
    """Batch-statistics BatchNorm over (B, valid positions) per channel.

    Matches flax ``nn.BatchNorm(use_running_average=False)`` on the valid
    columns (biased variance, eps inside the rsqrt); junk columns are
    excluded from the statistics but still normalised (they stay finite).

    ``axis_name``: sync-BN over the ranks of a process group (the data
    axis's, ``mesh.get_group("data")``; no axis name is in scope as under
    ``shard_map``).  As ``pmpx``'s two-pass form: the masked sums are
    summed over the group, the count is multiplied by the group's size,
    then the masked centred squares are summed over the group; two
    collectives (:func:`pmpx_torch.parallel.mesh.psum`, which ``vmap`` and
    ``grad`` transform).  The count is the global one only where every
    rank holds a shard of the same size, as ``pmpx`` assumes.
    """
    m = valid_mask(g, x.dtype, x.device)
    count = x.shape[0] * g.h * g.w
    s = torch.sum(x * m, dim=(0, 2))  # (C,)
    if axis_name is not None:
        from pmpx_torch.parallel.mesh import psum

        s = psum(s, axis_name)
        count = count * axis_name.size()
    mean = s / count
    centered = x - mean[:, None]
    v = torch.sum((centered * m) ** 2, dim=(0, 2))
    if axis_name is not None:
        v = psum(v, axis_name)
    var = v / count
    inv = torch.rsqrt(var + eps)
    return centered * (scale * inv)[:, None] + bias[:, None]


def max_pool2(x: torch.Tensor, g: Grid) -> tuple[torch.Tensor, Grid]:
    """2x2 stride-2 max pool.  Requires even h, wr, w so valid columns
    pool with valid columns and junk with junk."""
    if g.h % 2 or g.wr % 2 or g.w % 2:
        raise ValueError(f"max_pool2 needs even grid, got {g}")
    B, C, _ = x.shape
    x6 = x.reshape(B, C, g.h // 2, 2, g.wr // 2, 2)
    out = x6.amax(dim=(3, 5)).reshape(B, C, -1)
    return out, Grid(g.h // 2, g.wr // 2, g.w // 2)
