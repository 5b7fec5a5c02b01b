"""Row-sequence LSTM over MNIST digits (port of ``pmpx/models/lstm.py``).

Architecture parity with the reference LSTM model
(``complex_nets/Mnist/LSTM/PMP_LSTM.py:22-43``): each 28x28 digit is a
28-step sequence of 28-pixel rows through an LSTM with 64 hidden units;
the final step feeds a Dense(10) head.

The cell has the semantics and parameters of flax's ``OptimizedLSTMCell``:
gates [i|f|g|o], ``c' = sig(f)*c + sig(i)*tanh(g)``, ``h' = sig(o)*tanh(c')``,
a zero initial carry in float32, input kernels ``i{i,f,g,o}`` without
bias and the one bias on the hidden side ``h{i,f,g,o}``.  The recurrence
is an explicit loop, not ``torch.nn.LSTM``: cuDNN's LSTM does not compose
with ``torch.func.vmap`` over per-proposal weights.
"""

from __future__ import annotations

import torch
from torch import nn

from pmpx_torch.models._layers import Dense, dense

__all__ = ["MnistLSTM", "GATES"]

GATES = "ifgo"  # the column order of the stacked gate kernels


class _OptimizedLSTMCell(nn.Module):
    """Parameter holder named like flax's cell: ``i{g}.kernel`` (F, H),
    ``h{g}.kernel`` (H, H) and ``h{g}.bias`` (H) for g in i, f, g, o."""

    def __init__(self, features: int, hidden: int):
        super().__init__()
        for g in GATES:
            self.add_module(f"i{g}", Dense(features, hidden, use_bias=False))
            self.add_module(f"h{g}", Dense(hidden, hidden))


class MnistLSTM(nn.Module):
    def __init__(self, hidden: int = 64, num_classes: int = 10,
                 steps: int = 28, features: int = 28):
        super().__init__()
        self.hidden, self.steps, self.features = hidden, steps, features
        self.num_classes = num_classes
        self.add_module("OptimizedLSTMCell_0",
                        _OptimizedLSTMCell(features, hidden))
        self.add_module("Dense_0", Dense(hidden, num_classes))

    def flax_layout(self) -> list:
        """(flax path, shape, initialiser) of every leaf in the order of
        ``ravel_pytree`` over flax's tree (sorted keys): the head, then
        the cell's ``h{f,g,i,o}`` bias and kernel, then ``i{f,g,i,o}``."""
        H, F, C = self.hidden, self.features, self.num_classes
        cell = "OptimizedLSTMCell_0"
        out = [("Dense_0.bias", (C,), "zeros"),
               ("Dense_0.kernel", (H, C), "lecun_normal")]
        for g in sorted(GATES):
            out.append((f"{cell}.h{g}.bias", (H,), "zeros"))
            out.append((f"{cell}.h{g}.kernel", (H, H), "orthogonal"))
        for g in sorted(GATES):
            out.append((f"{cell}.i{g}.kernel", (F, H), "lecun_normal"))
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], self.steps, self.features)
        cell = self.OptimizedLSTMCell_0
        Wi = torch.cat([cell.get_submodule(f"i{g}").kernel for g in GATES],
                       dim=-1)
        Wh = torch.cat([cell.get_submodule(f"h{g}").kernel for g in GATES],
                       dim=-1)
        b = torch.cat([cell.get_submodule(f"h{g}").bias for g in GATES])
        c = h = x.new_zeros((x.shape[0], self.hidden), dtype=torch.float32)
        for t in range(self.steps):
            z = dense(h, Wh, b) + dense(x[:, t], Wi)
            zi, zf, zg, zo = z.chunk(4, dim=-1)
            c = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
            h = torch.sigmoid(zo) * torch.tanh(c)
        return self.Dense_0(h)
