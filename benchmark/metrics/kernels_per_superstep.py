"""Kernel records of the traced segment a superstep."""

from benchmark.metrics._trace import kernels


def read(rec):
    ks = kernels(rec)
    return len(ks) / rec["segment"]["supersteps"] if ks else None
