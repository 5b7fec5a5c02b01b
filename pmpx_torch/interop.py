"""Carry state from ``pmpx`` (JAX) into the port without importing either
JAX or ``pmpx``: data and states cross as NumPy arrays, configurations as
their fields.  The NN part (port of ``pmpx/interop.py``) maps torch
checkpoints, such as the reference's pretrained ``LSTM_model.pkl``, and
flax parameter trees onto an :class:`~pmpx_torch.targets.nn.NNPosterior`'s
theta."""

from __future__ import annotations

import dataclasses
import re
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
    "load_torch_pickle",
    "nn_theta_from_params",
    "pmp_config_from_jax",
    "theta_from_numpy",
    "theta_from_torch_state",
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


def load_torch_pickle(path: str) -> dict:
    """A torch ``.pkl``/``.pth`` state dict as NumPy arrays (CPU)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach().numpy() for k, v in sd.items()}


def _convert_linear(w: np.ndarray, b: np.ndarray) -> dict:
    # torch Linear stores (out, in); flax Dense kernel is (in, out)
    return {"kernel": w.T, "bias": b}


def _convert_conv(w: np.ndarray, b: np.ndarray) -> dict:
    # torch Conv2d (out, in, kh, kw) -> flax Conv (kh, kw, in, out)
    return {"kernel": np.transpose(w, (2, 3, 1, 0)), "bias": b}


def _nchw_to_nhwc_rows(w_t: np.ndarray, channels: int) -> np.ndarray:
    """Permute the input rows of an (in, out) dense kernel that reads a
    flattened conv feature map: torch flattens NCHW (row c*H*W + h*W + w),
    flax NHWC (row h*W*C + w*C + c).  The grid is square in every
    reference model (LeNet 16x5x5, ``cifar_PMPhmc.py:47``)."""
    d_in = w_t.shape[0]
    hw, rem = divmod(d_in, channels)
    side = int(round(hw ** 0.5))
    if rem or side * side != hw:
        raise ValueError(
            f"cannot infer a square conv grid from d_in={d_in}, "
            f"C={channels}")
    return w_t.reshape(channels, side, side, -1).transpose(
        1, 2, 0, 3).reshape(d_in, -1)


def _convert_lstm(w_ih, w_hh, b_ih, b_hh) -> dict:
    """torch ``nn.LSTM`` l0 tensors -> flax ``OptimizedLSTMCell`` leaves.
    Both stack the gates (i, f, g, o); flax keeps the one bias on the
    hidden side, so it receives b_ih + b_hh (only ever used summed)."""
    hidden = w_hh.shape[1]
    out = {}
    for g, name in enumerate("ifgo"):
        sl = slice(g * hidden, (g + 1) * hidden)
        out[f"i{name}"] = {"kernel": w_ih[sl].T}
        out[f"h{name}"] = {"kernel": w_hh[sl].T, "bias": b_ih[sl] + b_hh[sl]}
    return out


def _natural(name: str):
    # flax auto-names (Dense_0, Dense_10) sort by their numeric suffix
    m = re.match(r"(.*?)_(\d+)$", name)
    return (m.group(1), int(m.group(2))) if m else (name, -1)


def theta_from_torch_state(posterior, state: dict) -> torch.Tensor:
    """Map a torch state dict onto an ``NNPosterior``'s theta, by
    ``pmpx``'s rules: torch layers in insertion order, matched to the
    model's flax modules by kind in natural ``Dense_k`` order.  4-D weights
    are ``Conv`` kernels ((out, in, kh, kw) -> (kh, kw, in, out)), 2-D
    ``Dense`` kernels, 1-D weight/bias pairs ``BatchNorm`` scale/bias (the
    running statistics are ignored: the posterior normalises by the batch),
    ``nn.LSTM`` quadruples (``weight_ih_l0``, ``weight_hh_l0``, both
    biases) ``OptimizedLSTMCell`` leaves with ``b_ih + b_hh`` on the hidden
    side.  The first Dense after a conv stack gets its input rows permuted
    from torch's NCHW flatten to flax's NHWC.  A layer left over or missing
    raises ``ValueError``."""
    layers = []  # (kind, flax leaves) in the torch state's order
    seen_lstm = set()
    for k in state:
        m = re.match(r"(.*?)\.?weight_ih_l0$", k)
        if m:
            base = m.group(1)
            if base in seen_lstm:
                continue
            seen_lstm.add(base)
            pre = base + "." if base else ""
            layers.append(("lstm", _convert_lstm(
                state[f"{pre}weight_ih_l0"], state[f"{pre}weight_hh_l0"],
                state[f"{pre}bias_ih_l0"], state[f"{pre}bias_hh_l0"])))
            continue
        stem = k[: -len("weight")]
        if not k.endswith("weight") or stem + "bias" not in state:
            continue
        w, b = np.asarray(state[k]), np.asarray(state[stem + "bias"])
        if w.ndim == 4:
            layers.append(("conv", _convert_conv(w, b)))
        elif w.ndim == 2:
            layers.append(("dense", _convert_linear(w, b)))
        elif w.ndim == 1:
            layers.append(("norm", {"scale": w, "bias": b}))

    queues: dict = {}
    channels, first_dense = None, True
    for kind, leaves in layers:
        if kind == "conv":
            channels = leaves["kernel"].shape[-1]
        elif kind == "dense" and first_dense:
            first_dense = False
            if channels is not None:
                leaves = dict(leaves, kernel=_nchw_to_nhwc_rows(
                    leaves["kernel"], int(channels)))
        queues.setdefault(kind, []).append(leaves)

    kind_of = {"Conv": "conv", "Dense": "dense", "BatchNorm": "norm",
               "OptimizedLSTMCell": "lstm"}
    modules = sorted({path.split(".")[0] for path, _, _ in posterior.layout},
                     key=_natural)
    params = {}
    for name in modules:
        kind = kind_of.get(_natural(name)[0])
        if not queues.get(kind):
            raise ValueError(
                f"model expects a {kind!r} layer for {name} but the torch "
                f"state has none left")
        params[name] = queues[kind].pop(0)
    leftovers = {k: len(v) for k, v in queues.items() if v}
    if leftovers:
        raise ValueError(f"unconsumed torch layers: {leftovers}")
    return posterior.theta_from_params(params)


def nn_theta_from_params(posterior, params: dict) -> torch.Tensor:
    """An ``NNPosterior``'s theta from a flax parameter tree of NumPy
    arrays (what ``jax.tree.map(np.asarray, post._unravel(theta))`` gives
    for a ``pmpx`` posterior over the same model)."""
    return posterior.theta_from_params(params)
