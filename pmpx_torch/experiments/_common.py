"""Shared experiment plumbing (port of ``pmpx/experiments/_common.py``)."""

from __future__ import annotations

import numpy as np
import torch

from pmpx_torch.samplers.base import run_chain

__all__ = ["collect_samples", "maybe_plot", "as_tuple", "device_name",
           "seeded", "sync"]


def as_tuple(v):
    """Accept scalars for tuple-valued experiment knobs (the CLI parses a
    single `--Ps 4` as an int, `--Ps 4,16` as a tuple)."""
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,)


def device_name(device: torch.device) -> str:
    """The card's name (``torch.cuda.get_device_name``), else the device:
    what a saved result names as the device it ran on."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def seeded(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``: the
    port's counterpart of ``jax.random.key(seed)`` (another stream)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op off CUDA)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def collect_samples(superstep, generator, theta0, num_steps, burn_frac=0.2):
    """Run a chain and return flattened post-burn-in samples (n, d) as a
    NumPy array."""
    _, recs = run_chain(superstep, generator, theta0, num_steps)
    s = recs["samples"].detach().cpu().numpy()
    s = s.reshape(-1, s.shape[-1])
    return s[int(burn_frac * len(s)):]


def maybe_plot(fn):
    """Run a matplotlib plotting closure if matplotlib is importable."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    return fn(plt)
