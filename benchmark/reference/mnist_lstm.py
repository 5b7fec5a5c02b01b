"""Plain reference of the MNIST-LSTM posterior configuration.

Independent of the program: it imports nothing of ``pmpx_torch`` and takes
nothing the program made.  It holds

* the inputs' law (:func:`make_images`): a stand-in of MNIST's shape and
  law, 10 class prototypes N(0, 1) * class_sep plus unit noise per image,
  uniform labels (the law of ``pmpx_torch/data.py``'s stand-in, drawn here
  on the device from the run's seed);
* the chain's first state (:func:`init_theta`): biases 0, each kernel
  N(0, 1/fan_in), laid out as flax's ``ravel_pytree`` lays out the tree of
  ``OptimizedLSTMCell`` and ``Dense`` (:func:`layout`);
* the log-density (:func:`log_density`): log pi(theta) = -temper * mean
  cross-entropy of a 28-step row LSTM (64 hidden units, gates [i|f|g|o],
  c' = sig(f) c + sig(i) tanh(g), h' = sig(o) tanh(c'), zero initial
  carry, the one bias on the hidden side) and a Dense(10) head over every
  image, in float32 with TF32 off, one state at a time.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["layout", "make_images", "init_theta", "log_density"]

_GATES = "ifgo"
_CELL = "OptimizedLSTMCell_0"


def layout(config: dict) -> list:
    """(path, shape, fan_in or None for a bias) of every leaf, in flax's
    ravel order: sorted keys, the head first."""
    H, Fd, C = config["hidden"], config["features"], config["classes"]
    out = [("Dense_0.bias", (C,), None), ("Dense_0.kernel", (H, C), H)]
    for g in sorted(_GATES):
        out.append((f"{_CELL}.h{g}.bias", (H,), None))
        out.append((f"{_CELL}.h{g}.kernel", (H, H), H))
    for g in sorted(_GATES):
        out.append((f"{_CELL}.i{g}.kernel", (Fd, H), Fd))
    return out


def make_images(seed: int, config: dict, device) -> tuple:
    """(X (n, rows, features) float32, Y (n,) int64) on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n, C = config["n_train"], config["classes"]
    shape = (config["rows"], config["features"])
    protos = torch.randn((C, *shape), generator=gen, device=device)
    protos = protos * config["assumed"]["class_sep"]
    Y = torch.randint(0, C, (n,), generator=gen, device=device)
    X = protos[Y] + torch.randn((n, *shape), generator=gen, device=device)
    return X, Y


def init_theta(seed: int, config: dict, device) -> torch.Tensor:
    """The first state (d,) float32 on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    leaves = []
    for _, shape, fan_in in layout(config):
        numel = 1
        for s in shape:
            numel *= s
        if fan_in is None:
            leaves.append(torch.zeros(numel, device=device))
        else:
            leaves.append(torch.randn(numel, generator=gen, device=device)
                          / fan_in ** 0.5)
    return torch.cat(leaves)


def _unravel(theta: torch.Tensor, config: dict) -> dict:
    out, off = {}, 0
    for path, shape, _ in layout(config):
        numel = 1
        for s in shape:
            numel *= s
        out[path] = theta[off:off + numel].reshape(shape)
        off += numel
    return out


def log_density(theta: torch.Tensor, X: torch.Tensor, Y: torch.Tensor,
                config: dict) -> torch.Tensor:
    """log pi of each state of ``theta`` (m, d), float32 on X's device."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = [_one(t.to(X.device, torch.float32), X, Y, config)
               for t in theta]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    return torch.stack(out)


def _one(theta, X, Y, config):
    p = _unravel(theta, config)
    Wi = torch.cat([p[f"{_CELL}.i{g}.kernel"] for g in _GATES], dim=1)
    Wh = torch.cat([p[f"{_CELL}.h{g}.kernel"] for g in _GATES], dim=1)
    b = torch.cat([p[f"{_CELL}.h{g}.bias"] for g in _GATES])
    n = X.shape[0]
    x = X.reshape(n, config["rows"], config["features"])
    h = torch.zeros((n, config["hidden"]), device=X.device)
    c = torch.zeros_like(h)
    for t in range(config["rows"]):
        z = h @ Wh + b + x[:, t] @ Wi
        zi, zf, zg, zo = z.chunk(4, dim=1)
        c = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
        h = torch.sigmoid(zo) * torch.tanh(c)
    logits = h @ p["Dense_0.kernel"] + p["Dense_0.bias"]
    return -config["temper"] * F.cross_entropy(logits, Y)
