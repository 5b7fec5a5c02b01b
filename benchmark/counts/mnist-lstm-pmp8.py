"""Operations and bytes of the MNIST-LSTM configuration's work, counted from
its shapes as the algorithm needs them.

One LSTM forward of an image for one proposal: 28 steps, each the two gate
products 2 * (F + H) * 4H flops (F = 28 pixels, H = 64); the cell update
and the gates' transcendentals are not counted.  The head 2 * H * 10 and
the cross-entropy are the superstep's, outside the kernel.  Bytes: the
images once a call, the P proposals' gate weights, the final hidden
states written.  A superstep evaluates P = N + 1 proposals over every
image (binary tree of depth log2(N + 1)).
"""

from __future__ import annotations

__all__ = ["superstep", "lstm_call"]

_F32 = 4


def _P(config: dict) -> int:
    return config["sampler"]["N"] + 1


def lstm_call(config: dict) -> tuple:
    """(flops, bytes) of one ``lstm_fused`` launch over P proposals."""
    T, F, H = config["rows"], config["features"], config["hidden"]
    B, P = config["n_train"], _P(config)
    flops = 2.0 * (F + H) * 4 * H * T * B * P
    weights = P * ((F + H) * 4 * H + 4 * H)
    return flops, _F32 * (B * T * F + weights + P * B * H)


def superstep(config: dict, traffic: dict) -> tuple:
    """(flops, bytes) of one superstep: the LSTM call, and the head and
    cross-entropy (2 * H * C + 4 * C flops an image and proposal)."""
    H, C, B, P = (config["hidden"], config["classes"], config["n_train"],
                  _P(config))
    f, b = lstm_call(config)
    return f + P * B * (2.0 * H * C + 4.0 * C), b
