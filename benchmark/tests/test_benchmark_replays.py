"""The ``supersteps_per_replay`` reader: the program's counters, a program
without them, and the counters of the program's own CPU run."""

import pytest

torch = pytest.importorskip("torch")

from benchmark import harness as H  # noqa: E402
from pmpx_torch import profiling  # noqa: E402

TRACED = {"segment": {}}


def _read(rec=TRACED):
    cell = H.load_cell("linreg-p1024-sweep")
    return cell.module("metrics", "supersteps_per_replay").read(rec)


def test_reads_replayed_supersteps_over_replays(monkeypatch):
    monkeypatch.setitem(profiling.counters, "replays", 4)
    monkeypatch.setitem(profiling.counters, "replayed_supersteps", 127)
    assert _read() == pytest.approx(31.75)


def test_none_where_nothing_was_replayed(monkeypatch):
    monkeypatch.setitem(profiling.counters, "replays", 0)
    monkeypatch.setitem(profiling.counters, "replayed_supersteps", 0)
    assert _read() is None


def test_none_without_the_counters(monkeypatch):
    """A program whose counters lack them (the parent of this reader), or
    that has no counters at all, gives None."""
    monkeypatch.delitem(profiling.counters, "replays")
    monkeypatch.delitem(profiling.counters, "replayed_supersteps")
    assert _read() is None
    monkeypatch.delattr(profiling, "counters")
    assert _read() is None


def test_reads_a_cpu_run():
    """A CompiledChain(capture=False) of unroll 2, runs of 5 and 4: step 0
    eagerly, then 2 + 2, then 2 + 2 (the counters are the process's, so
    the run moves them by that much)."""
    from pmpx_torch.samplers import base

    def sup(g, s):
        s = s + torch.rand(s.shape, generator=g)
        return s, {"x": s.sum()}

    g = torch.Generator()
    g.manual_seed(0)
    chain = base.CompiledChain(sup, g, torch.zeros(3), unroll=2,
                               capture=False)
    before = dict(profiling.counters)
    chain.run(g, torch.zeros(3), 5)
    chain.run(g, torch.zeros(3), 4)
    moved = {k: profiling.counters[k] - before[k]
             for k in ("replays", "replayed_supersteps")}
    assert moved == {"replays": 4, "replayed_supersteps": 8}
    assert _read() >= 1.0
