"""Supersteps completed by all chains in the window, over the window's
seconds (host clock; the window ends at the sync after its last launch)."""


def read(rec):
    return rec["supersteps"] / rec["window_s"]
