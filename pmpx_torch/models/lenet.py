"""LeNet for CIFAR-10 with BatchNorm (port of ``pmpx/models/lenet.py``).

Architecture parity with the reference
(``complex_nets/Cifar-10/cifar_PMPhmc.py:33-55``): conv(3->6, 5x5) -> BN ->
relu -> maxpool -> conv(6->16, 5x5) -> BN -> relu -> maxpool -> FC(400->120)
-> relu -> FC(84) -> relu -> FC(10).  BatchNorm always runs on the
statistics of the batch at hand (flax's ``use_running_average=False``,
eps 1e-5, its fast variance E[x^2] - E[x]^2); no running statistics are
kept, so nothing but the parameters enters theta.

The input is NHWC (B, 32, 32, 3), as ``pmpx`` takes it; the convolutions
run NCHW (the layout cuDNN's convolutions take natively) with flax's
(kh, kw, in, out) kernels, and the feature map is permuted back to NHWC
before the flatten, so ``Dense_0``'s 400 rows mean what they mean in
``pmpx`` (row h*80 + w*16 + c).

``remat=True`` recomputes each conv block in the backward pass (only the
block's inputs are saved), through a ``torch.autograd.Function`` that
``torch.func`` can transform (``torch.utils.checkpoint`` cannot run under
``torch.func.grad``); the parameter tree is the same, so thetas interop
with the plain model.

``bn_axis``: sync-BN for data-parallel full-batch evaluation (global batch
statistics; :class:`pmpx_torch.parallel.ShardedNNPosterior`).  No axis
name is in scope as under ``shard_map``, so it holds the data axis's
process group (``mesh.get_group("data")``), over which each BatchNorm
averages its statistics (:func:`pmpx_torch.models._layers.batch_norm`);
``with_bn_axis(axis)`` rebinds it.  Every rank must hold a shard of the
same size.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.func import vjp

from pmpx_torch.models._layers import (
    BatchNorm, Conv, Dense, batch_norm, conv_flax, flax_layout, max_pool2,
)

__all__ = ["LeNet"]


def _block(x, kernel, bias, scale, bn_bias, group=None):
    x = conv_flax(x, kernel, bias)
    x = torch.relu(batch_norm(x, scale, bn_bias, group=group))
    return max_pool2(x)


class _RematBlock(torch.autograd.Function):
    """``_block`` that saves only its inputs and recomputes itself in the
    backward pass (a ``torch.func``-compatible rematerialisation).  With
    sync-BN the recompute runs the block's collective again, on every
    rank alike."""

    generate_vmap_rule = True

    @staticmethod
    def forward(*args):
        with torch.no_grad():
            return _block(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:5])
        ctx.group = inputs[5]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        with torch.enable_grad():
            _, pull = vjp(lambda *a: _block(*a, group=ctx.group),
                          *ctx.saved_tensors)
        return (*pull(g), None)


class LeNet(nn.Module):
    def __init__(self, num_classes: int = 10, remat: bool = False,
                 bn_axis=None):
        super().__init__()
        self.num_classes = num_classes
        self.remat = remat
        self.bn_axis = bn_axis
        self.Conv_0, self.BatchNorm_0 = Conv(3, 6, 5), BatchNorm(6)
        self.Conv_1, self.BatchNorm_1 = Conv(6, 16, 5), BatchNorm(16)
        self.Dense_0 = Dense(16 * 5 * 5, 120)
        self.Dense_1 = Dense(120, 84)
        self.Dense_2 = Dense(84, num_classes)

    def flax_layout(self) -> list:
        return flax_layout(self)

    def with_bn_axis(self, axis):
        """The sync-BN variant over ``axis`` (same parameters)."""
        return LeNet(self.num_classes, remat=self.remat, bn_axis=axis)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, 32, 32, 3) NHWC -> NCHW for the convolutions
        x = x.permute(0, 3, 1, 2)
        block = _RematBlock.apply if self.remat else _block
        for conv, bn in ((self.Conv_0, self.BatchNorm_0),
                         (self.Conv_1, self.BatchNorm_1)):
            x = block(x, conv.kernel, conv.bias, bn.scale, bn.bias,
                      self.bn_axis)
        # flatten in NHWC order, as flax does
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = torch.relu(self.Dense_0(x))
        x = torch.relu(self.Dense_1(x))
        return self.Dense_2(x)
