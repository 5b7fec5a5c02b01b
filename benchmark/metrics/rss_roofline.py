"""Per cent of its roofline that ``rss_kernel`` reaches: 5 P n flops and x
and y read once, over its mean device time a call."""

from benchmark.metrics._trace import roofline_pct


def read(rec):
    counts = rec["counts"]
    if counts is None or not hasattr(counts, "rss_call"):
        return None
    return roofline_pct(rec, "rss_kernel", *counts.rss_call(rec["config"]))
