"""4-layer MLP over flattened MNIST digits (port of
``pmpx/models/mlp.py``).

Architecture parity with the reference FC model
(``complex_nets/Mnist/FC/PMP_FC.py:21-36``): 784-512-256-128-10, ReLU.
"""

from __future__ import annotations

import torch
from torch import nn

from pmpx_torch.models._layers import Dense

__all__ = ["MnistMLP"]


class MnistMLP(nn.Module):
    def __init__(self, widths: tuple = (512, 256, 128),
                 num_classes: int = 10, d_in: int = 28 * 28):
        super().__init__()
        dims = (d_in, *widths, num_classes)
        self.names = [f"Dense_{k}" for k in range(len(dims) - 1)]
        for name, a, b in zip(self.names, dims[:-1], dims[1:]):
            self.add_module(name, Dense(a, b))

    def flax_layout(self) -> list:
        """(flax path, shape, initialiser) of every leaf in the order of
        ``ravel_pytree`` over flax's tree: sorted module names, each
        ``bias`` before its ``kernel``."""
        out = []
        for name in sorted(self.names):
            kernel = self.get_submodule(name).kernel
            out.append((f"{name}.bias", (kernel.shape[1],), "zeros"))
            out.append((f"{name}.kernel", tuple(kernel.shape),
                        "lecun_normal"))
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for name in self.names[:-1]:
            x = torch.relu(self.get_submodule(name)(x))
        return self.get_submodule(self.names[-1])(x)
