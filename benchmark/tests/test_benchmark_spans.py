"""The span and counter readers (``outside_chain_pct``, ``launch_host_us``,
``capture_s``) on synthetic spans, on a program without spans, and on the
program's own spans from a CPU run."""

import pytest

torch = pytest.importorskip("torch")

from benchmark import harness as H  # noqa: E402
from pmpx_torch import profiling  # noqa: E402

TRACED = {"segment": {}}


def _reader(name):
    return H.load_cell("linreg-p1024-sweep").module("metrics", name)


def _span(i, name, parent, dev, host=None):
    host = dev if host is None else host
    return {"id": i, "name": name, "parent": parent, "attrs": {},
            "host_start_us": host[0], "host_end_us": host[1],
            "device_start_us": dev[0], "device_end_us": dev[1]}


# two launches of the fused chain: a seed draw, the kernel and a gather in
# each, and 20 µs of idle between them
TWO_LAUNCHES = [
    _span(2, "fused.seeds", 1, (0.0, 5.0)),
    _span(3, "fused.kernel", 1, (10.0, 90.0)),
    _span(4, "fused.gather", 1, (92.0, 100.0)),
    _span(1, "fused.run", None, (0.0, 100.0), host=(1000.0, 1030.0)),
    _span(6, "fused.seeds", 5, (120.0, 125.0)),
    _span(7, "fused.kernel", 5, (130.0, 210.0)),
    _span(8, "fused.gather", 5, (212.0, 220.0)),
    _span(5, "fused.run", None, (120.0, 220.0), host=(1040.0, 1090.0)),
]


@pytest.fixture
def program(monkeypatch):
    """Make the program's spans() give ``found``."""
    def give(found):
        monkeypatch.setattr(profiling, "spans", lambda: found)
    return give


def test_outside_chain_counts_idle_and_seed_draws(program):
    """W = 220 µs from the first run's device start to the last one's
    end; the kernels take 160: the seed draws, the gathers and the 20 µs
    of idle between the launches are outside."""
    program(TWO_LAUNCHES)
    got = _reader("outside_chain_pct").read(TRACED)
    assert got == pytest.approx(100.0 * 60.0 / 220.0)
    assert 0.0 <= got <= 100.0


@pytest.mark.parametrize("work", ["farm.kernel", "chain.replay"])
def test_outside_chain_counts_every_runner(program, work):
    """The farm's kernel and the compiled chain's replays are the
    superstep's own work too; chain.records are not."""
    found = [_span(2, work, 1, (0.0, 40.0)),
             _span(3, "chain.records", 1, (40.0, 50.0)),
             _span(4, work, 1, (50.0, 90.0)),
             _span(1, work.split(".")[0] + ".run", None, (0.0, 100.0))]
    program(found)
    assert _reader("outside_chain_pct").read(TRACED) == pytest.approx(20.0)


def test_launch_host_us_is_the_mean_of_the_runs(program):
    program(TWO_LAUNCHES)
    assert _reader("launch_host_us").read(TRACED) == pytest.approx(40.0)


@pytest.mark.parametrize("name", ["outside_chain_pct", "launch_host_us",
                                  "capture_s"])
def test_readers_give_none_without_spans(monkeypatch, name):
    """A program without spans and counters (the parent of this reader),
    or a run that traced no segment, gives None."""
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "counters")
    assert _reader(name).read(TRACED) is None
    assert _reader(name).read({"segment": None}) is None


@pytest.mark.parametrize("name", ["outside_chain_pct", "launch_host_us"])
def test_span_readers_give_none_without_a_run(program, name):
    program([_span(1, "chain.records", None, (0.0, 1.0))])
    assert _reader(name).read(TRACED) is None
    program([])
    assert _reader(name).read(TRACED) is None


def test_capture_s_reads_the_counter(monkeypatch):
    monkeypatch.setitem(profiling.counters, "capture_s", 1.25)
    assert _reader("capture_s").read(TRACED) == 1.25


def test_readers_on_a_cpu_run():
    """The program's own spans of a CPU run: host times only, so
    outside_chain_pct has nothing to read and launch_host_us is a time."""
    from pmpx_torch.samplers import base

    def sup(g, s):
        s = s + torch.rand(s.shape, generator=g)
        return s, {"x": s.sum()}

    g = torch.Generator()
    g.manual_seed(0)
    chain = base.CompiledChain(sup, g, torch.zeros(3), unroll=2,
                               capture=False)
    profiling.reset()
    try:
        with profiling.recording():
            chain.run(g, torch.zeros(3), 5)
            chain.run(g, torch.zeros(3), 5)
        assert _reader("outside_chain_pct").read(TRACED) is None
        assert _reader("launch_host_us").read(TRACED) > 0.0
    finally:
        profiling.reset()
    assert _reader("capture_s").read(TRACED) > 0.0
