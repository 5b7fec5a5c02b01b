"""Profiling and tracing hooks (port of ``pmpx/profiling.py``).

A context manager around any region writes a ``torch.profiler`` Chrome
trace under a directory; :func:`device_time_us` sums the newest trace's
kernel time by name, so perf work reads time on the card rather than the
host's clock; :func:`superstep_timer` times a chain's supersteps with
CUDA events on a card and ``time.perf_counter`` on the CPU.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import time
from contextlib import contextmanager
from typing import Callable, Dict

import torch
from torch.profiler import ProfilerActivity, profile

__all__ = ["trace", "device_time_us", "superstep_timer"]


@contextmanager
def trace(log_dir: str):
    """``with pmpx_torch.profiling.trace(dir): ...`` captures the host's
    ops and, where there is a card, its kernels; the Chrome trace is
    written to ``log_dir/trace_<ns>.json`` when the block ends (after the
    card has finished the block's work).  Yields the profiler."""
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


def device_time_us(log_dir: str, prefix: str = "",
                   category: str = "kernel") -> Dict[str, float]:
    """Durations (µs) summed by name over the events of ``category`` in
    the newest trace under ``log_dir``; ``prefix`` keeps names that start
    with it.  The default category is the card's kernels; a trace taken
    without a card has none (pass ``category="cpu_op"`` for the host's
    ops: the reading never falls back to them by itself)."""
    files = sorted(glob.glob(os.path.join(log_dir, "trace_*.json")))
    if not files:
        raise FileNotFoundError(f"no trace under {log_dir}")
    with open(files[-1]) as fh:
        tr = json.load(fh)
    agg: Dict[str, float] = collections.defaultdict(float)
    for e in tr.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") != category:
            continue
        if prefix and not e["name"].startswith(prefix):
            continue
        agg[e["name"]] += float(e.get("dur", 0.0))
    return dict(agg)


def _device_of(obj):
    """The device of the first tensor in ``obj`` (nested tuples, lists
    and dicts), or None."""
    if isinstance(obj, torch.Tensor):
        return obj.device
    items = obj.values() if isinstance(obj, dict) else (
        obj if isinstance(obj, (tuple, list)) else ())
    for o in items:
        dev = _device_of(o)
        if dev is not None:
            return dev
    return None


def superstep_timer(run_fn: Callable, *args, iters: int,
                    warmup: bool = True) -> float:
    """µs per superstep of ``run_fn(*args)``, which runs ``iters``
    supersteps, after one warm-up call (``warmup``).  Timed by CUDA events
    when the arguments (or, failing that, the results) lie on a card,
    else by ``time.perf_counter``."""
    dev = _device_of(args)
    if warmup:
        out = run_fn(*args)
        dev = dev or _device_of(out)
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
    if dev is not None and dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run_fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / iters
    t0 = time.perf_counter()
    dev = _device_of(run_fn(*args))
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / iters * 1e6
