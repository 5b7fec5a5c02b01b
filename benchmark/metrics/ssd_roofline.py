"""Per cent of its roofline that ``mamba2_ssd_kernel`` reaches: one Mamba
layer's scan for every proposal's sequences (5 * head_dim * d_state flops
a head and token; x, B, C, dt read and y written once), over its mean
device time a call."""

from benchmark.metrics._trace import roofline_pct


def read(rec):
    counts = rec["counts"]
    if counts is None or not hasattr(counts, "ssd_call"):
        return None
    return roofline_pct(rec, "mamba2_ssd", *counts.ssd_call(rec["config"]))
