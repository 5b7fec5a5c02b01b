"""Metrics and trace persistence (port of ``pmpx/metrics``; only the
recorder so far)."""

from pmpx_torch.metrics.recorder import (
    load_trace,
    reference_style_name,
    save_trace,
)

__all__ = ["save_trace", "load_trace", "reference_style_name"]
