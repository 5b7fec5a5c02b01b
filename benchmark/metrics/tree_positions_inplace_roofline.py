"""Per cent of its roofline that ``tree_positions_inplace_kernel`` reaches:
the binary tree's P positions written over the P innovations (each read
and written once, the state read once, float32), over its mean device time
a call."""

from benchmark.metrics._trace import roofline_pct


def read(rec):
    counts = rec["counts"]
    if counts is None or not hasattr(counts, "positions_call"):
        return None
    return roofline_pct(rec, "tree_positions_inplace",
                        *counts.positions_call(rec["config"]))
