"""Speedup analysis of loss traces (the A100 BNN notebook's protocol);
the port's own copy of ``pmpx/metrics/analysis.py`` (NumPy and SciPy).

Parity with ``Bayesian Network Training/MNIST_bnn_NVIDIAA100.ipynb`` cells
20-28: Savitzky-Golay-smooth the loss traces, find the first iteration at
which each trace crosses a set of loss thresholds, and fit the linear
relation between PMP and SP iterations-to-threshold — the slope is the
reported iteration-speedup of prefetching.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = ["smooth_loss", "first_crossing", "iteration_speedup"]


def smooth_loss(
    loss: np.ndarray, window: int = 101, polyorder: int = 3
) -> np.ndarray:
    """Savitzky-Golay smoothing (falls back to a moving average if scipy is
    unavailable).  ``window`` is clipped to the trace length (odd)."""
    loss = np.asarray(loss, np.float64)
    window = min(window, len(loss) - (1 - len(loss) % 2))
    if window < polyorder + 2:
        return loss
    if window % 2 == 0:
        window -= 1
    try:
        from scipy.signal import savgol_filter

        return savgol_filter(loss, window, polyorder)
    except Exception:
        k = np.ones(window) / window
        return np.convolve(loss, k, mode="same")


def first_crossing(
    loss: np.ndarray, thresholds: Sequence[float]
) -> np.ndarray:
    """First iteration index where ``loss`` drops to/below each threshold
    (NaN when never reached)."""
    loss = np.asarray(loss)
    out = np.full(len(thresholds), np.nan)
    for i, th in enumerate(thresholds):
        hits = np.nonzero(loss <= th)[0]
        if hits.size:
            out[i] = hits[0]
    return out


def iteration_speedup(
    loss_fast: np.ndarray,
    loss_base: np.ndarray,
    thresholds: Sequence[float] | None = None,
    window: int = 101,
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Linear fit of baseline vs. fast iterations-to-threshold.

    Returns (slope, fast_crossings, base_crossings); slope > 1 means the
    fast sampler reaches equal loss in fewer iterations by that factor
    (the notebook's headline PMP-vs-SP number)."""
    sf = smooth_loss(loss_fast, window)
    sb = smooth_loss(loss_base, window)
    if thresholds is None:
        lo = max(sf.min(), sb.min())
        hi = min(sf[0], sb[0])
        thresholds = np.linspace(hi - 0.05 * (hi - lo), lo + 0.05 * (hi - lo), 12)
    cf = first_crossing(sf, thresholds)
    cb = first_crossing(sb, thresholds)
    ok = ~(np.isnan(cf) | np.isnan(cb))
    if ok.sum() < 2:
        return float("nan"), cf, cb
    # least-squares through the origin: base ~= slope * fast
    slope = float(np.dot(cb[ok], cf[ok]) / np.dot(cf[ok], cf[ok]))
    return slope, cf, cb
