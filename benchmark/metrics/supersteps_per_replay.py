"""Supersteps a replay of the compiled chain covered, over the run: the
program's ``replayed_supersteps`` counter over its ``replays``.  None where
the program has no such counters or replayed nothing."""

from benchmark.metrics._spans import counter


def read(rec):
    replays, steps = counter("replays"), counter("replayed_supersteps")
    if not replays or steps is None:
        return None
    return steps / replays
