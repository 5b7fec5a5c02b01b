"""Per cent of its roofline that ``lstm_fused_kernel`` reaches: the gate
products of P proposals over every image, over its mean device time a
call."""

from benchmark.metrics._trace import roofline_pct


def read(rec):
    counts = rec["counts"]
    if counts is None or not hasattr(counts, "lstm_call"):
        return None
    return roofline_pct(rec, "lstm_fused_kernel",
                        *counts.lstm_call(rec["config"]))
