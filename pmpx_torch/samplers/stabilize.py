"""Weight stabilization devices (port of ``pmpx/samplers/stabilize.py``).

* ``none`` — exact log-space weights.
* ``zscore`` — ``(logA - mean)/std`` (population std, over the last axis:
  leading axes are a batch of chains), which tempers the selection law;
  kept for parity with the reference NN experiments.
* NaN/Inf guard — NaN and ``+inf`` logits become 0 (weight 1); ``-inf``
  stays, as a legitimate "never select this node".
"""

from __future__ import annotations

import torch

__all__ = ["stabilize_logits"]


def stabilize_logits(
    logA: torch.Tensor, mode: str = "none", nan_guard: bool = True
) -> torch.Tensor:
    if mode == "zscore":
        mean = torch.mean(logA, dim=-1, keepdim=True)
        std = torch.std(logA, dim=-1, correction=0, keepdim=True)
        logA = (logA - mean) / torch.clamp(std, min=1e-30)
    elif mode != "none":
        raise ValueError(f"unknown stabilizer mode: {mode!r}")
    if nan_guard:
        bad = torch.isnan(logA) | (logA == float("inf"))
        logA = torch.where(bad, torch.zeros_like(logA), logA)
    return logA
