"""Effective samples a second: the smallest over the coordinates of the
ESS of the window's root draws (Geyer, summed over chains), over the
window's seconds."""

from benchmark.reference.checks import chain_ess


def read(rec):
    ess = chain_ess(rec["outputs"]["draws"]).sum(0)
    return float(ess.min()) / rec["window_s"]
