"""What the per-layer readers share: the traced segment's kernels, and a
kernel's roofline share."""

from __future__ import annotations

__all__ = ["kernels", "per_superstep_us", "roofline_pct", "peak_flops"]


def kernels(rec: dict) -> list:
    """(name, µs) of every kernel record of the traced segment ([] when the
    run traced none)."""
    seg = rec["segment"]
    if seg is None:
        return []
    return [(name, dur) for name, dur, _, cat in seg["ops"]
            if cat == "kernel"]


def per_superstep_us(rec: dict, keep) -> float | None:
    """µs a superstep of the kernels whose name ``keep`` accepts."""
    ks = kernels(rec)
    if not ks:
        return None
    return sum(d for n, d in ks if keep(n)) / rec["segment"]["supersteps"]


def peak_flops(rec: dict) -> float | None:
    peaks = rec["peaks"]
    if peaks is None:
        return None
    return peaks["flops"].get(rec["config"]["dtype"])


def roofline_pct(rec: dict, kernel: str, flops: float,
                 nbytes: float) -> float | None:
    """100 * the least time the card could take for one call (operations
    at the configuration's peak rate, or bytes at the memory's, the
    larger) over the mean device time of a ``kernel`` record; None where
    the segment holds no such record."""
    calls = [d for n, d in kernels(rec) if kernel in n]
    peak = peak_flops(rec)
    if not calls or peak is None:
        return None
    bound = max(flops / peak, nbytes / rec["peaks"]["bytes_per_s"])
    return 100.0 * bound / (sum(calls) / len(calls) / 1e6)
