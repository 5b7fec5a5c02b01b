"""The MNIST-CNN forward for all P proposals in one pass (port of
``pmpx/kernels/cnn_fast.py``).

The reference CNN posterior (``complex_nets/Mnist/CNN/PMP_CNN.py:20-42``,
conv(1->10, 5x5) -> relu -> maxpool 2 -> conv(10->20, 3x3) -> relu ->
FC(2000->500) -> FC(10), full batch) evaluates P networks a superstep.  On
the generic path (``vmap`` of the model) conv1 contracts K = 25 taps
against 10 output channels per network.  This path reshapes the same
arithmetic into fewer, wider operations (float reassociation only, no
approximation):

* **space-to-depth conv1**: the 28x28 input becomes 4 phase channels on a
  14x14 grid; the stride-1 5x5 conv becomes a 3x3 conv over 4 input
  channels that yields the four 12x12 output phases of every filter, and
  with all P proposals' filters stacked on the output channels it is one
  convolution with P*4*10 outputs (the scattered kernel has 25 live taps
  of 36 per phase).
* **phase-max pooling**: the 2x2/2 maxpool windows are exactly the four
  conv1 output phases at each coarse pixel, so the pool is a max over the
  phase axis, and ``maxpool(relu(z + b)) == relu(max_phase(z) + b)``
  (relu is monotone, the bias constant over the phases).
* **proposal-grouped conv2**: all P proposals' (3, 3, 10, 20) filters run
  as one grouped convolution (``groups=P``) over the (B, P*10, 12, 12)
  pooled stack, the channels proposal-major.
* **batched head**: the dense layers are P-batched (B, 2000) @ (2000, 500)
  products.

The convolutions and products are cuDNN's and cuBLAS's (``F.conv2d``,
``torch.bmm``); ``pmpx``'s counterpart holds no Pallas kernel either.

:func:`attach` installs it as the ``NNPosterior`` density (forward only:
the MNIST protocols never differentiate the superstep).  Its rounding
differs from the generic path's by reassociation, and densities feed
acceptance weights, so it is a protocol field, as ``lstm_kernel`` is: a
kernel-path chain never splices onto a generic-path prefix
(``pmpx_torch/experiments/mnist.py``'s sidecars).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["make_fast_log_prob_batch", "attach"]


def _s2d_scatter_indices():
    """Index map scattering the (5, 5) stride-1 taps into the (3, 3, 4)
    space-to-depth kernel, per output phase.

    For output phase (py, px) and tap (ky, kx), the contributing input
    pixel sits at spatial offset (u, v) = ((py + ky) // 2, (px + kx) // 2)
    in input phase d = ((py + ky) % 2, (px + kx) % 2).  The map
    ky -> (u, dy) is injective for fixed py, so each target slot holds a
    single source tap.
    """
    ph, u, v, d, ky, kx = [], [], [], [], [], []
    for py in range(2):
        for px in range(2):
            for a in range(5):
                for b in range(5):
                    ph.append(py * 2 + px)
                    u.append((py + a) // 2)
                    v.append((px + b) // 2)
                    d.append(((py + a) % 2) * 2 + ((px + b) % 2))
                    ky.append(a)
                    kx.append(b)
    return tuple(np.asarray(i) for i in (ph, u, v, d, ky, kx))


_PH, _U, _V, _D, _KY, _KX = _s2d_scatter_indices()
_INDEX = {}  # device -> the index map as tensors there (one copy each)


def _space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, 28, 28) -> (B, 14, 14, 4) with phase channel d = dy*2 + dx."""
    B = x.shape[0]
    x = x.reshape(B, 14, 2, 14, 2)
    return x.permute(0, 1, 3, 2, 4).reshape(B, 14, 14, 4)


def _s2d_conv1_weights(w1: torch.Tensor) -> torch.Tensor:
    """(P, 5, 5, 10) flax conv1 kernels -> (3, 3, 4, P*4*10) space-to-depth
    kernels (flax's HWIO), output channels ordered (proposal, phase,
    filter)."""
    P = w1.shape[0]
    if w1.device not in _INDEX:
        _INDEX[w1.device] = [torch.as_tensor(i, device=w1.device)
                             for i in (_U, _V, _D, _PH, _KY, _KX)]
    u, v, d, ph, ky, kx = _INDEX[w1.device]
    out = torch.zeros((P, 3, 3, 4, 4, 10), dtype=w1.dtype, device=w1.device)
    # the 25 live taps of each phase (100 slots of 144)
    out[:, u, v, d, ph, :] = w1[:, ky, kx, :]
    return out.permute(1, 2, 3, 0, 4, 5).reshape(3, 3, 4, P * 40)


def _forward_logits(leaves: dict, x_s2d: torch.Tensor, dt) -> torch.Tensor:
    """All-P logits (P, B, 10) from the posterior's unravelled leaves
    {flax path: (P, ...)}; ``x_s2d`` is the NCHW (B, 4, 14, 14) phase
    stack."""
    cast = (lambda a: a.to(dt)) if dt is not None else (lambda a: a)
    w1 = cast(leaves["Conv_0.kernel"][:, :, :, 0, :])  # (P, 5, 5, 10)
    b1 = cast(leaves["Conv_0.bias"])                   # (P, 10)
    w2 = cast(leaves["Conv_1.kernel"])                 # (P, 3, 3, 10, 20)
    b2 = cast(leaves["Conv_1.bias"])                   # (P, 20)
    wf1 = cast(leaves["Dense_0.kernel"])               # (P, 2000, 500)
    bf1 = cast(leaves["Dense_0.bias"])                 # (P, 500)
    wf2 = cast(leaves["Dense_1.kernel"])               # (P, 500, 10)
    bf2 = cast(leaves["Dense_1.bias"])                 # (P, 10)
    P, B = w1.shape[0], x_s2d.shape[0]

    # conv1 as a space-to-depth conv: (B, 4, 14, 14) -> (B, P*40, 12, 12)
    k1 = _s2d_conv1_weights(w1).permute(3, 2, 0, 1)  # OIHW
    z = F.conv2d(x_s2d.to(k1.dtype), k1)
    # phase-max pooling, then bias and relu (== conv1 -> relu -> maxpool)
    z = z.reshape(B, P, 4, 10, 12, 12).amax(dim=2)
    z = torch.relu(z + b1[None, :, :, None, None])

    # conv2: one grouped conv, proposal-major channel blocks (group p reads
    # channels p*10 ... p*10 + 9 and writes p*20 ... p*20 + 19)
    k2 = w2.permute(0, 4, 3, 1, 2).reshape(P * 20, 10, 3, 3)
    z = F.conv2d(z.reshape(B, P * 10, 12, 12), k2, groups=P)
    z = torch.relu(z.reshape(B, P, 20, 10, 10) + b2[None, :, :, None, None])

    # head: flax flattens (10, 10, 20) channels-last -> 2000
    act = z.permute(1, 0, 3, 4, 2).reshape(P, B, 2000)
    h = torch.relu(torch.bmm(act, wf1) + bf1[:, None, :])
    return torch.bmm(h, wf2) + bf2[:, None, :]


def make_fast_log_prob_batch(posterior):
    """A ``log_prob_batch(Theta)`` for an NNPosterior over
    ``pmpx_torch.models.MnistCNN``.

    Keeps one NCHW space-to-depth copy of ``posterior.X`` per bound
    dataset (made again only when ``posterior.X`` is another tensor),
    honours ``compute_dtype`` as the generic path does (parameters and
    activations cast, the loss in f32) and ``proposal_chunk`` (that many
    networks at once; it must divide P).
    """
    cache = {}

    def phases():
        X = posterior.X
        if cache.get("X") is not X:
            x = X[..., 0] if X.ndim == 4 else X
            cache["X"] = X
            cache["s2d"] = _space_to_depth(x).permute(0, 3, 1, 2).contiguous()
        return cache["s2d"]

    def fast(Theta: torch.Tensor) -> torch.Tensor:
        x_s2d = phases()
        P = Theta.shape[0]
        c = posterior.proposal_chunk
        if c is None or c >= P:
            c = P
        elif P % c:
            raise ValueError(
                f"proposal_chunk={c} must divide the batch size {P}"
            )
        logits = torch.cat([
            _forward_logits(posterior.unravel(Theta[i:i + c]), x_s2d,
                            posterior.compute_dtype)
            for i in range(0, P, c)])
        _, B, C = logits.shape
        ce = F.cross_entropy(logits.float().reshape(P * B, C),
                             posterior.Y.repeat(P),
                             reduction="none").reshape(P, B).mean(dim=1)
        return -posterior.temper * ce

    return fast


def attach(posterior) -> None:
    """Install the one-pass density on an MnistCNN NNPosterior.

    After this ``log_prob_batch`` and ``log_prob`` evaluate through the
    space-to-depth path (the same math as the generic path up to float
    reassociation); ``value_and_grad_batch`` keeps the generic path.
    Raises ``ValueError`` for a posterior over another model, or a
    stochastic one.
    """
    shapes = {path: shape for path, shape, _ in getattr(posterior, "layout",
                                                        ())}
    ok = (shapes.get("Conv_0.kernel") == (5, 5, 1, 10)
          and shapes.get("Conv_1.kernel") == (3, 3, 10, 20)
          and "Dense_0.kernel" in shapes and "Dense_1.kernel" in shapes)
    if not ok:
        raise ValueError(
            "attach() requires an NNPosterior over "
            "pmpx_torch.models.MnistCNN (Conv_0 5x5x1x10 -> Conv_1 "
            "3x3x10x20 -> Dense_0 -> Dense_1)"
        )
    if posterior.stochastic:
        raise ValueError("fast CNN path is deterministic-only")
    posterior._fast_batch = make_fast_log_prob_batch(posterior)
