"""What the span readers share: the spans the program kept in the traced
segment (``pmpx_torch.profiling`` keeps them while ``torch.profiler`` is
active, and only the segment runs under it), its counters, and the two
readings of a list of spans.  A program without spans or counters gives
None."""

from __future__ import annotations

__all__ = ["CHAIN_WORK", "spans", "counter", "outside_pct", "host_us"]

# the spans of the superstep's own work: a launch of a chain kernel, a
# replay of a captured chain (a superstep of the eager chain)
CHAIN_WORK = ("fused.kernel", "farm.kernel", "chain.replay")


def _profiling():
    try:
        from pmpx_torch import profiling
    except ImportError:
        return None
    return profiling


def spans(rec: dict) -> list | None:
    """The program's finished spans, or None where the run traced no
    segment or the program keeps no spans."""
    read = getattr(_profiling(), "spans", None)
    return None if read is None or rec["segment"] is None else read()


def counter(name: str):
    """The program's counter ``name``, or None where it has none."""
    counters = getattr(_profiling(), "counters", None)
    return None if counters is None else counters.get(name)


def _runs(found: list) -> list:
    """The spans of one call of a chain runner (``fused.run``,
    ``farm.run``, ``chain.run``)."""
    return [s for s in found if s["name"].endswith(".run")]


def outside_pct(found: list) -> float | None:
    """100 × (W − the device time of the CHAIN_WORK spans) / W, W the
    device time from the earliest device start of the runner calls to the
    latest device end; None without device times."""
    calls = [s for s in _runs(found) if s["device_start_us"] is not None]
    if not calls:
        return None
    window = (max(s["device_end_us"] for s in calls)
              - min(s["device_start_us"] for s in calls))
    work = sum(s["device_end_us"] - s["device_start_us"] for s in found
               if s["name"] in CHAIN_WORK and s["device_start_us"] is not None)
    return 100.0 * (window - work) / window


def host_us(found: list) -> float | None:
    """The mean host µs of the runner calls; None without one."""
    calls = _runs(found)
    if not calls:
        return None
    return sum(s["host_end_us"] - s["host_start_us"]
               for s in calls) / len(calls)
