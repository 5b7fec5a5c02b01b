"""Packed-layout executors for the conv models (port of
``pmpx/models/packed.py``): drop-in ``LeNet`` and ``MnistCNN``.

Same parameters, same math, another physical layout: ``PackedLeNet`` and
``PackedMnistCNN`` are ``LeNet`` and ``MnistCNN`` with their parameters
and ``flax_layout()`` (so thetas, checkpoints and the torch interop of
``pmpx_torch.interop`` carry across bit-equal), whose forward pass runs in
the channel-packed ``(B, C, H*Wr)`` layout of
``pmpx_torch.kernels.convpack`` (convolutions as shifted contiguous
slices and products).

``pmpx`` measured this layout as a negative result: its native NHWC
convolutions were faster and smaller.  The card's numbers are
``pmpx_torch.experiments.nn_perf``'s (PERF.md §6).  ``bn_axis``: sync-BN
statistics over the data axis's process group under data sharding
(``convpack.batchnorm``'s ``axis_name``; :class:`pmpx_torch.parallel.
ShardedNNPosterior` binds it through ``with_bn_axis``).  ``PackedMnistCNN``
has no BatchNorm and takes the axis without reading it, as ``pmpx``'s
does.
"""

from __future__ import annotations

import torch

from pmpx_torch.kernels import convpack as cp
from pmpx_torch.models._layers import dense
from pmpx_torch.models.cnn import MnistCNN
from pmpx_torch.models.lenet import LeNet

__all__ = ["PackedLeNet", "PackedMnistCNN", "lenet_packed_apply",
           "cnn_packed_apply"]


def _dense(params: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return dense(x, params[f"{name}.kernel"], params[f"{name}.bias"])


def lenet_packed_apply(params: dict, x: torch.Tensor, remat: bool = True,
                       bn_axis=None) -> torch.Tensor:
    """LeNet's forward (``models/lenet.py``) in packed layout.

    ``params``: {flax path: leaf}; x: (B, 32, 32, 3) NHWC -> logits (B, 10).
    ``bn_axis``: the process group for sync-BN statistics under data
    sharding.
    """
    y, g = cp.pack_images(x)
    for k in (0, 1):
        y, g = cp.conv2d(y, params[f"Conv_{k}.kernel"],
                         params[f"Conv_{k}.bias"], g, remat=remat)
        y = cp.batchnorm(y, params[f"BatchNorm_{k}.scale"],
                         params[f"BatchNorm_{k}.bias"], g,
                         axis_name=bn_axis)
        y, g = cp.max_pool2(torch.relu(y), g)
    h = cp.unpack(y, g).reshape(x.shape[0], -1)  # NHWC flatten order
    h = torch.relu(_dense(params, "Dense_0", h))
    h = torch.relu(_dense(params, "Dense_1", h))
    return _dense(params, "Dense_2", h)


def cnn_packed_apply(params: dict, x: torch.Tensor, remat: bool = True,
                     bn_axis=None) -> torch.Tensor:
    """MnistCNN's forward (``models/cnn.py``) in packed layout.

    x: (B, 28, 28[, 1]) -> logits (B, 10).  (``bn_axis`` is taken for the
    shims' uniformity; MnistCNN has no BatchNorm.)
    """
    y, g = cp.pack_images(x)
    y, g = cp.conv2d(y, params["Conv_0.kernel"], params["Conv_0.bias"], g,
                     remat=remat)
    y, g = cp.max_pool2(torch.relu(y), g)
    y, g = cp.conv2d(y, params["Conv_1.kernel"], params["Conv_1.bias"], g,
                     remat=remat)
    h = cp.unpack(torch.relu(y), g).reshape(x.shape[0], -1)  # (B, 2000)
    h = torch.relu(_dense(params, "Dense_0", h))
    return _dense(params, "Dense_1", h)


class _Packed:
    """The packed forward over the base model's parameters (which
    ``torch.func.functional_call`` swaps for a theta's leaves)."""

    _packed_forward = None

    def _setup(self, remat: bool, bn_axis) -> None:
        self.remat = remat
        self.bn_axis = bn_axis

    def with_bn_axis(self, axis):
        """The sync-BN variant for data-parallel shards (same params)."""
        return type(self)(remat=self.remat, bn_axis=axis)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = {}
        for path, _, _ in self.flax_layout():
            mod, leaf = path.split(".")
            params[path] = getattr(getattr(self, mod), leaf)
        return type(self)._packed_forward(params, x, remat=self.remat,
                                          bn_axis=self.bn_axis)


class PackedLeNet(_Packed, LeNet):
    _packed_forward = staticmethod(lenet_packed_apply)

    def __init__(self, remat: bool = True, bn_axis=None,
                 num_classes: int = 10):
        LeNet.__init__(self, num_classes=num_classes)
        self._setup(remat, bn_axis)


class PackedMnistCNN(_Packed, MnistCNN):
    _packed_forward = staticmethod(cnn_packed_apply)

    def __init__(self, remat: bool = True, bn_axis=None,
                 num_classes: int = 10):
        MnistCNN.__init__(self, num_classes=num_classes)
        self._setup(remat, bn_axis)
