"""Exact-resume checkpointing of (chain state, generator state, step) (port
of ``pmpx/checkpoint.py``).

A checkpoint is a self-contained ``.npz``: the chain state ``theta``, the
byte state of the chain's ``torch.Generator`` (``gen_state``, with the
device it lives on, ``gen_device``), the step counter, any ``extra_*``
arrays, and ``backend = "torch"``.

``pmpx`` keys step *s* as ``fold_in(base_key, s)``, so it stores the
unsplit key.  The port threads one generator through :func:`run_chain`
instead, so a checkpoint stores the generator's state at the chunk
boundary and a resume restores it with ``set_state``.  The supersteps
then draw exactly what an uninterrupted chain would have drawn: a chunked
or resumed run is bit-equal to one ``run_chain`` of the same seed and step
count (a chunk boundary only copies records to the host; it serves the
generator nothing).

A ``pmpx`` checkpoint (``key_data``, no ``backend``) is refused, and
:func:`adopt_prefix_run` never adopts another backend's run: a torch chain
is never spliced onto a JAX chain.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from pmpx_torch.samplers.base import compile_chain

__all__ = [
    "adopt_prefix_run",
    "write_protocol_sidecar",
    "save_checkpoint",
    "load_checkpoint",
    "resume_chain",
    "TraceAccumulator",
]

BACKEND = "torch"


def _to_numpy(recs):
    """Records (tensors through dicts and tuples) as host NumPy arrays."""
    if isinstance(recs, dict):
        return {k: _to_numpy(v) for k, v in recs.items()}
    if isinstance(recs, (tuple, list)):
        return tuple(_to_numpy(v) for v in recs)
    if isinstance(recs, torch.Tensor):
        return recs.detach().cpu().numpy()
    return np.asarray(recs)


class TraceAccumulator:
    """Accumulate per-chunk trace arrays on disk (an ``on_chunk`` helper).

    A resumed :func:`resume_chain` returns only the chunks it ran, so a
    full-history trace is persisted chunk by chunk: each named array is
    appended to ``<out_dir>/<name>.<key>.npy``, truncated at the chunk's
    start step, so a re-run chunk overwrites its own identical records.
    ``chunk_walls`` holds the wall clock at the end of each chunk; the
    first chunk includes the kernels' build and warm-up, so the steady
    per-step time is ``median(diff(chunk_walls)[1:])``
    (:meth:`steady_s_per_step`).
    """

    def __init__(self, out_dir: str, name: str, keys, fresh: bool = True):
        self.out_dir = out_dir
        self.keys = tuple(keys)
        self.paths = {
            k: os.path.join(out_dir, f"{name}.{k}.npy") for k in self.keys
        }
        self.chunk_walls = []
        self._t0 = time.time()
        os.makedirs(out_dir, exist_ok=True)
        if fresh:
            for p in self.paths.values():
                if os.path.exists(p):
                    os.remove(p)

    def __call__(self, start: int, recs):
        if not isinstance(recs, (tuple, list)):
            recs = (recs,)
        if len(recs) != len(self.keys):
            raise ValueError(
                f"chunk returned {len(recs)} arrays for keys {self.keys}"
            )
        for k, arr in zip(self.keys, recs):
            arr = np.asarray(arr)
            p = self.paths[k]
            prev = (
                np.load(p) if os.path.exists(p)
                else np.zeros((0,) + arr.shape[1:], arr.dtype)
            )
            if len(prev) < start:
                # a silent pad or cut here would shift the whole trace;
                # the checkpoint and the .npy must agree
                raise RuntimeError(
                    f"{p} holds {len(prev)} records but the resumed "
                    f"chunk starts at step {start}: trace and checkpoint "
                    "are out of sync (deleted .npy, or keys changed "
                    "mid-run?)"
                )
            np.save(p, np.concatenate([prev[:start], arr]))
        self.chunk_walls.append(time.time() - self._t0)

    def load(self, key=None):
        return np.load(self.paths[key or self.keys[0]])

    def steady_s_per_step(self, chunk_steps: int):
        """Per-step wall time without the first (warm-up) chunk."""
        diffs = np.diff([0.0] + self.chunk_walls)
        if len(diffs) < 2:
            return None
        return float(np.median(diffs[1:]) / chunk_steps)


def write_protocol_sidecar(out_dir: str, stem: str, protocol: dict) -> str:
    """Record the protocol knobs the trace stem does not encode (temper,
    data knobs, seed, dtype, ...) in ``<stem>.protocol.json``, with
    ``backend = "torch"``, so that :func:`adopt_prefix_run` can refuse to
    splice two different targets, or two backends, into one trace."""
    path = os.path.join(out_dir, stem + ".protocol.json")
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump({**protocol, "backend": BACKEND}, f, indent=1,
                  sort_keys=True)
    return path


def _ckpt_backend(path: str) -> Optional[str]:
    try:
        with np.load(path) as z:
            return str(z["backend"]) if "backend" in z.files else None
    except Exception:
        return None


def adopt_prefix_run(
    out_dir: str, name_of, num_steps: int, keys=(),
    protocol: Optional[dict] = None,
) -> Optional[int]:
    """Adopt the longest shorter run of the same protocol as a resume seed.

    Trace stems embed ``num_steps`` (``reference_style_name``'s
    ``sample_number_{steps}``), so a relaunch with a larger step target
    would start from scratch although a resumable prefix checkpoint sits
    beside it under the old stem.  Given ``name_of(steps) -> stem``, this
    finds the sibling ``.ckpt`` with the largest embedded step count below
    ``num_steps`` whose stem round-trips through ``name_of``, whose
    checkpoint is this backend's, and, when ``protocol`` is given, whose
    ``.protocol.json`` sidecar equals ``protocol`` with ``backend =
    "torch"``; then copies its checkpoint and the given per-chunk trace
    arrays to the new stem.  A candidate with no sidecar is adopted with a
    loud warning; one whose sidecar differs (another posterior, or a
    ``pmpx`` run) is skipped.  Copy, not move: the shorter run stays a
    result of its own.  Returns the adopted run's step count, or None (also
    when the new stem's checkpoint exists).
    """
    new_name = name_of(num_steps)
    new_ckpt = os.path.join(out_dir, new_name + ".ckpt")
    if os.path.exists(new_ckpt) or not os.path.isdir(out_dir):
        return None
    want = None if protocol is None else {**protocol, "backend": BACKEND}
    best, best_had_sidecar = None, True
    for fn in os.listdir(out_dir):
        if not fn.endswith(".ckpt"):
            continue
        m = re.search(r"sample_number_(\d+)", fn)
        if not m:
            continue
        steps = int(m.group(1))
        if not (steps < num_steps and fn[:-5] == name_of(steps)):
            continue
        if _ckpt_backend(os.path.join(out_dir, fn)) != BACKEND:
            continue  # a pmpx (JAX) chain: never splice
        had_sidecar = True
        if want is not None:
            side = os.path.join(out_dir, fn[:-5] + ".protocol.json")
            if os.path.exists(side):
                with open(side) as f:
                    if json.load(f) != want:
                        continue  # another posterior, chain or backend
            else:
                had_sidecar = False
        if best is None or steps > best:
            best, best_had_sidecar = steps, had_sidecar
    if best is None:
        return None
    old_name = name_of(best)
    if protocol is not None and not best_had_sidecar:
        print(
            f"WARNING: adopting prefix run {old_name!r}, which has no "
            "protocol sidecar; its temper/data/seed/dtype knobs are "
            "unverifiable: confirm they match before trusting the spliced "
            "trace",
            flush=True,
        )
    for suffix in [".ckpt"] + [f".{k}.npy" for k in keys]:
        src = os.path.join(out_dir, old_name + suffix)
        if os.path.exists(src):
            shutil.copy2(src, os.path.join(out_dir, new_name + suffix))
    if protocol is not None:
        write_protocol_sidecar(out_dir, new_name, protocol)
    return best


def save_checkpoint(
    path: str,
    theta: torch.Tensor,
    generator: torch.Generator,
    step: int,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Write (theta, the generator's state, step, extra) to ``path``.

    Crash-safe: the archive goes to ``path + ".tmp"``, is flushed and
    fsynced, then replaces ``path`` in one ``os.replace``, so a kill at any
    moment leaves either the old checkpoint or the new one, never a torn
    file.
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {
        "theta": _to_numpy(theta),
        "gen_state": generator.get_state().numpy(),
        "gen_device": np.asarray(str(generator.device)),
        "step": np.asarray(step),
        "backend": np.asarray(BACKEND),
    }
    for k, v in (extra or {}).items():
        arrays[f"extra_{k}"] = _to_numpy(v)
    # savez to an open handle: np.savez(path_str) appends '.npz'
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str):
    """(theta, generator, step, extra) from a checkpoint of this port.

    The generator is rebuilt on the device it was saved from, with its
    saved state; theta and the extras move to that device.  A ``pmpx``
    checkpoint raises ``ValueError``.
    """
    with np.load(path) as z:
        files = set(z.files)
        backend = str(z["backend"]) if "backend" in files else None
        if backend != BACKEND:
            what = ("a pmpx (JAX) checkpoint" if "key_data" in files
                    else f"backend {backend!r}")
            raise ValueError(
                f"{path} is {what}, not a pmpx_torch checkpoint: a torch "
                "chain is never resumed from, or spliced onto, another "
                "backend's chain"
            )
        dev = torch.device(str(z["gen_device"]))
        gen = torch.Generator(device=dev)
        gen.set_state(torch.from_numpy(z["gen_state"].copy()))
        theta = torch.from_numpy(z["theta"].copy()).to(dev)
        step = int(z["step"])
        extra = {
            k[len("extra_"):]: torch.from_numpy(np.array(z[k])).to(dev)
            for k in files if k.startswith("extra_")
        }
    return theta, gen, step, extra


def resume_chain(
    superstep,
    path: str,
    total_steps: int,
    collect=None,
    checkpoint_every: Optional[int] = None,
    on_chunk=None,
):
    """Run a chain to ``total_steps`` from the checkpoint at ``path``.

    Each chunk of ``checkpoint_every`` supersteps is one run of one
    compiled chain (:func:`~pmpx_torch.samplers.base.compile_chain`: the
    first chunk captures, the others only replay), from the checkpoint's
    theta and generator; its records go to the host
    as NumPy arrays, ``on_chunk(start_step, recs)`` is called with them
    *before* the new checkpoint is written (a crash between the two at
    worst re-runs one chunk, whose records overwrite identically), and the
    checkpoint then holds the state and the generator after the chunk.
    The returned records cover only the chunks this call ran; a caller that
    needs the whole history persists it through ``on_chunk``
    (:class:`TraceAccumulator`).  Returns (theta, list of chunk records).
    """
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no checkpoint at {path}; save one with save_checkpoint first"
        )
    theta, gen, step, _ = load_checkpoint(path)
    chunk = checkpoint_every or max(total_steps - step, 1)
    recs_all = []
    chain = compile_chain(superstep, gen, theta, collect)
    while step < total_steps:
        n = min(chunk, total_steps - step)
        theta, recs = chain.run(gen, theta, n)
        recs = _to_numpy(recs)
        recs_all.append(recs)
        if on_chunk is not None:
            on_chunk(step, recs)
        step += n
        save_checkpoint(path, theta, gen, step)
    return theta, recs_all
