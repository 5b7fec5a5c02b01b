"""Small MNIST CNN (port of ``pmpx/models/cnn.py``).

Architecture parity with the reference CNN model
(``complex_nets/Mnist/CNN/PMP_CNN.py:20-42``): conv(1->10, 5x5, valid) ->
relu -> maxpool 2 -> conv(10->20, 3x3, valid) -> relu -> FC(2000->500) ->
relu -> FC(10).  (The reference applies log_softmax before
CrossEntropyLoss, a double log-softmax not reproduced; logits are
returned.)

The input is (B, 28, 28) or (B, 28, 28, 1), as ``pmpx`` takes it; the
convolutions run NCHW with flax's (kh, kw, in, out) kernels, and the
feature map is permuted back to NHWC before the flatten, so ``Dense_0``'s
2000 rows mean what they mean in ``pmpx`` (row h*200 + w*20 + c).
"""

from __future__ import annotations

import torch
from torch import nn

from pmpx_torch.models._layers import (
    Conv, Dense, conv_flax, flax_layout, max_pool2,
)

__all__ = ["MnistCNN"]


class MnistCNN(nn.Module):
    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.Conv_0 = Conv(1, 10, 5)
        self.Conv_1 = Conv(10, 20, 3)
        self.Dense_0 = Dense(20 * 10 * 10, 500)
        self.Dense_1 = Dense(500, num_classes)

    def flax_layout(self) -> list:
        return flax_layout(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (B, 28, 28[, 1]) -> NCHW (B, 1, 28, 28)
        x = x[:, None] if x.ndim == 3 else x.permute(0, 3, 1, 2)
        x = torch.relu(conv_flax(x, self.Conv_0.kernel, self.Conv_0.bias))
        x = max_pool2(x)  # (B, 10, 12, 12)
        x = torch.relu(conv_flax(x, self.Conv_1.kernel, self.Conv_1.bias))
        # flatten (B, 20, 10, 10) in NHWC order, as flax does
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = torch.relu(self.Dense_0(x))
        return self.Dense_1(x)
