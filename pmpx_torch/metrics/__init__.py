"""Metrics and trace persistence (port of ``pmpx/metrics``)."""

from pmpx_torch.metrics.analysis import (
    first_crossing,
    iteration_speedup,
    smooth_loss,
)
from pmpx_torch.metrics.ess import (
    autocov, autocov_chunked, ess, ess_chunked, ess_per_dim, split_rhat,
)
from pmpx_torch.metrics.mixing import move_rate, msjd, skewness
from pmpx_torch.metrics.recorder import (
    load_trace,
    reference_style_name,
    save_trace,
)

__all__ = [
    "first_crossing",
    "iteration_speedup",
    "smooth_loss",
    "autocov",
    "autocov_chunked",
    "ess_chunked",
    "ess",
    "ess_per_dim",
    "split_rhat",
    "move_rate",
    "msjd",
    "skewness",
    "load_trace",
    "reference_style_name",
    "save_trace",
]
