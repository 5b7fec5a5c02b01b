"""Profiling and tracing hooks (port of ``pmpx/profiling.py``).

A context manager around any region writes a ``torch.profiler`` Chrome
trace under a directory; :func:`device_time_us` sums the newest trace's
kernel time by name, so perf work reads time on the card rather than the
host's clock; :func:`superstep_timer` times a chain's supersteps with
CUDA events on a card and ``time.perf_counter`` on the CPU.

Spans and counters.  The chain runners open a :func:`span` at each of
their layer's boundaries (``fused.*`` in
:func:`pmpx_torch.kernels.fused_chain.make_fused_chain`, ``farm.*`` in
:func:`pmpx_torch.parallel.chains.make_chain_farm_fused`, ``chain.*`` in
:class:`pmpx_torch.samplers.base.CompiledChain` and
:func:`~pmpx_torch.samplers.base.run_chain_eager`), and an NN posterior's
batched density is ``nn.density`` wherever it runs outside a capture
(:meth:`pmpx_torch.targets.nn.NNPosterior.log_prob_batch`: step 0, eager
chains, a check's evaluation).  A span is kept while
a ``torch.profiler`` profile is active or inside :func:`recording`;
otherwise a span site costs one check and keeps nothing.  A kept span
holds its name, the span that opened it, its host start and end in µs of
``time.time_ns()`` (the clock of the profiler's Chrome trace: an event's
``ts`` is that less the trace's ``baseTimeNanoseconds`` / 1e3), and, on a
CUDA device, a pair of timing events recorded on the current stream just
before its first enqueue and just after its last (none while the stream
captures a graph), read only by :func:`spans`.  Under a profiler each span
is also a ``record_function`` range, so the Chrome trace shows it as a
``user_annotation`` on the host and a ``gpu_user_annotation`` over its
kernels.  Spans do not reach inside a captured superstep: a range opened
during capture is host code and is not replayed.  :data:`counters` holds
the always-on counts: ``launches`` (the dict
:data:`pmpx_torch.kernels.launches`) and ``capture_s``, the host seconds
that :class:`~pmpx_torch.samplers.base.CompiledChain` spent in its first
step and graph captures.  The recorder serves one thread.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import itertools
import json
import os
import time
from contextlib import contextmanager
from typing import Callable, Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from pmpx_torch.kernels import launches

__all__ = ["trace", "device_time_us", "superstep_timer", "span",
           "recording", "spans", "reset", "counters"]

counters = {"launches": launches, "capture_s": 0.0}

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_on = [0]        # depth of the open recording() blocks
_ids = itertools.count(1)
_open: list = []  # the spans open now, innermost last
_done: list = []  # the finished spans, in the order they finished
_pool: dict = {}  # card index -> free timing events
_origin: dict = {}  # card index -> the first event recorded since reset()


@contextmanager
def recording():
    """Keep every span opened inside the block, with or without a
    profiler."""
    _on[0] += 1
    try:
        yield
    finally:
        _on[0] -= 1


def span(name: str, device: Optional[torch.device] = None, **attrs):
    """``with span("fused.kernel", dev, steps=chunk): ...`` keeps the block
    as a span where spans are kept (see the module's docstring), and is a
    no-op otherwise.  ``device``: the ``torch.device`` where the block
    enqueues its work (timing events are recorded on a CUDA device only,
    on its current stream); ``attrs``: what the span counts (``steps``,
    and ``chains`` where there are several)."""
    traced = _profiling()
    if not (_on[0] or traced):
        return _OFF
    return _Span(name, device, attrs, traced)


class _Span:
    __slots__ = ("rec", "device", "range")

    def __init__(self, name, device, attrs, traced):
        self.rec = {"id": next(_ids), "name": name,
                    "parent": _open[-1]["id"] if _open else None,
                    "attrs": attrs, "device_start_us": None,
                    "device_end_us": None, "_events": None}
        self.device = device
        self.range = record_function(name) if traced else None

    def __enter__(self):
        rec = self.rec
        rec["host_start_us"] = time.time_ns() / 1e3
        if self.range is not None:
            self.range.__enter__()
        if (self.device is not None and self.device.type == "cuda"
                and not torch.cuda.is_current_stream_capturing()):
            stream = torch.cuda.current_stream(self.device)
            pool = _pool.setdefault(stream.device_index, [])
            start, end = (pool.pop() if pool else
                          torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record(stream)
            _origin.setdefault(stream.device_index, start)
            rec["_events"] = (stream, start, end)
        _open.append(rec)
        return rec

    def __exit__(self, *exc):
        rec = _open.pop()
        if rec["_events"] is not None:
            stream, _, end = rec["_events"]
            end.record(stream)
        if self.range is not None:
            self.range.__exit__(*exc)
        rec["host_end_us"] = time.time_ns() / 1e3
        _done.append(rec)
        return False


def spans() -> list:
    """A snapshot of the finished spans, in the order they finished: dicts
    of ``id``, ``name``, ``parent`` (the id of the span open where it
    opened, or None), ``attrs``, ``host_start_us`` and ``host_end_us`` (µs
    of ``time.time_ns()``), ``device_start_us`` and ``device_end_us`` (µs
    after the first event recorded on its card since :func:`reset`; None
    where it has no events).  Reading an event waits for the card to reach
    it; nothing is cleared."""
    out = []
    for rec in _done:
        if rec["_events"] is not None and rec["device_end_us"] is None:
            stream, start, end = rec["_events"]
            end.synchronize()
            origin = _origin.setdefault(stream.device_index, start)
            rec["device_start_us"] = origin.elapsed_time(start) * 1e3
            rec["device_end_us"] = origin.elapsed_time(end) * 1e3
        out.append({k: v for k, v in rec.items() if k != "_events"})
    return out


def reset() -> None:
    """Drop the finished spans; their events go back to the pool."""
    for rec in _done:
        if rec["_events"] is not None:
            stream, start, end = rec["_events"]
            _pool[stream.device_index] += (start, end)
    _done.clear()
    _origin.clear()


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
