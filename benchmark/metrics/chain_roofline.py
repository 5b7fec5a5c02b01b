"""Per cent of its roofline that the chain megakernel reaches: the needed
work of ``chunk`` supersteps of every chain of a launch, over the mean
device time of a ``chain_*_kernel`` record."""

from benchmark.metrics._trace import roofline_pct


def read(rec):
    counts, t = rec["counts"], rec["traffic"]
    if counts is None or not hasattr(counts, "chain_launch"):
        return None
    work = counts.chain_launch(rec["config"], t["chunk"], t.get("chains", 1))
    return roofline_pct(rec, "chain_", *work)
