"""Carry state from ``pmpx`` (JAX) into the port without importing either
JAX or ``pmpx``: data and states cross as NumPy arrays, configurations as
their fields."""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from pmpx_torch._device import resolve_device
from pmpx_torch.samplers.pmp import PMPConfig
from pmpx_torch.targets import analytic
from pmpx_torch.targets.linreg import BayesLinReg

__all__ = [
    "analytic_from_jax",
    "linreg_from_numpy",
    "pmp_config_from_jax",
    "theta_from_numpy",
]


def linreg_from_numpy(x, y, *, temper: float = 1.0, method: str = "auto",
                      device=None) -> BayesLinReg:
    """A :class:`BayesLinReg` over the same data as a ``pmpx`` target
    (pass ``np.asarray(target.x)``, ``np.asarray(target.y)``)."""
    return BayesLinReg(
        np.asarray(x, np.float32), np.asarray(y, np.float32),
        temper=temper, method=method, device=device,
    )


def pmp_config_from_jax(cfg) -> PMPConfig:
    """The port's :class:`PMPConfig` from a ``pmpx.PMPConfig`` (or any
    object with its fields as attributes) or from a dict of its fields."""
    names = [f.name for f in dataclasses.fields(PMPConfig)]
    if isinstance(cfg, Mapping):
        fields = {k: cfg[k] for k in names if k in cfg}
    else:
        fields = {k: getattr(cfg, k) for k in names if hasattr(cfg, k)}
    return PMPConfig(**fields)


def theta_from_numpy(theta, *, device=None) -> torch.Tensor:
    """A chain state (float32) on ``device`` from a NumPy or JAX array."""
    return torch.tensor(
        np.asarray(theta, np.float32), device=resolve_device(device)
    )


def analytic_from_jax(target):
    """The port's analytic target (``Gaussian1D``, ``StandardMVN`` or
    ``Banana``) with the fields of a ``pmpx.targets`` one of the same
    class name."""
    cls = getattr(analytic, type(target).__name__, None)
    if cls is None or not dataclasses.is_dataclass(cls):
        raise TypeError(f"no analytic target of the port matches "
                        f"{type(target).__name__}")
    return cls(**{f.name: getattr(target, f.name)
                  for f in dataclasses.fields(cls)})
