"""Trace recording and persistence (the port's own copy of
``pmpx/metrics/recorder.py``, which has no JAX in it; importing it would
pull JAX in through ``pmpx``'s ``__init__``).

Traces are saved once as ``.npz`` bundles with a JSON manifest, plus a
helper producing the reference implementation's file names
(``'PMP_alpha_'+str(alpha)+"_sample_number_"+str(num_steps)+...``,
``PMP_FC.py:197``) for drop-in analysis scripts.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

import numpy as np

__all__ = ["save_trace", "reference_style_name", "load_trace"]


def reference_style_name(
    algo: str, alpha: float, num_steps: int, model: str = "", N: int = 0
) -> str:
    """Reference-convention file stem (``PMP_FC.py:197`` pattern)."""
    stem = f"{algo}_alpha_{alpha}_sample_number_{num_steps}"
    if model:
        stem += model
    if N:
        stem += f"_N_{N}"
    return stem


def save_trace(
    out_dir: str,
    name: str,
    arrays: Dict[str, np.ndarray],
    meta: Dict[str, Any] | None = None,
) -> str:
    """Save arrays + JSON metadata; returns the .npz path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name + ".npz")
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in arrays.items()})
    manifest = dict(meta or {})
    manifest.setdefault("saved_at", time.strftime("%Y-%m-%dT%H:%M:%S"))
    manifest["arrays"] = {
        k: list(np.asarray(v).shape) for k, v in arrays.items()
    }
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return path


def load_trace(path: str):
    return dict(np.load(path))
