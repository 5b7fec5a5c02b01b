"""The chain runners' spans and counters (``pmpx_torch.profiling``) on the
CPU: nothing is kept with recording off, each runner's span tree under
``recording()``, the spans in ``profiling.trace``'s Chrome trace on its
clock, and draws bit-equal with recording on and off.
``tests/test_torch_gpu.py`` holds the device intervals on a card."""

import collections
import glob
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pmpx_torch import profiling  # noqa: E402
from pmpx_torch.kernels import fused_chain as fc  # noqa: E402
from pmpx_torch.kernels import launches  # noqa: E402
from pmpx_torch.parallel import chains  # noqa: E402
from pmpx_torch.samplers import base, pmp  # noqa: E402
from pmpx_torch.targets.linreg import BayesLinReg  # noqa: E402

N_DATA = 300
CFG = pmp.PMPConfig(N=1, depth=3, step_size=0.05, selection="all_first")
THETA0 = torch.tensor([0.0, 0.0, 1.0])


def _data():
    x, y = np.random.default_rng(0).normal(size=(2, N_DATA)).astype(
        np.float32)
    return x, -1.0 + 2.0 * x + 0.5 * y


@pytest.fixture(scope="module")
def fused_target():
    return BayesLinReg(*_data(), temper=0.05, method="fused", device="cpu")


@pytest.fixture(scope="module")
def sweep_target():
    return BayesLinReg(*_data(), temper=0.05, method="sweep", device="cpu")


@pytest.fixture(autouse=True)
def _fresh():
    profiling.reset()
    yield
    profiling.reset()


def _gen(seed=5):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _chain(target, unroll=3):
    sup = pmp.make_superstep(target, CFG)
    return base.CompiledChain(sup, _gen(), THETA0, lambda s, o: s, unroll,
                              capture=False)


def _runners(fused_target, sweep_target):
    """name -> (a call of the runner from a fresh generator, its root span,
    its supersteps)."""
    fused = fc.make_fused_chain(fused_target, CFG, chunk=8, rng="kernel")
    farm = chains.make_chain_farm_fused(fused_target, CFG, 20, chunk=8)
    th = torch.stack([THETA0, THETA0 + 0.1])
    sup = pmp.make_superstep(sweep_target, CFG)
    return {
        "fused": lambda: fused(_gen(), THETA0, 20),
        "farm": lambda: farm(chains.chain_generators(5, 2, "cpu"), th),
        "compiled": lambda: _chain(sweep_target).run(_gen(), THETA0, 7),
        "eager": lambda: base.run_chain_eager(sup, _gen(), THETA0, 7),
    }


def _tree(found):
    """(the root span, {name: [its children of that name]}), checking that
    every span but the root has it as parent."""
    roots = [s for s in found if s["parent"] is None]
    assert len(roots) == 1
    root = roots[0]
    kids = collections.defaultdict(list)
    for s in found:
        if s is not root:
            assert s["parent"] == root["id"], s
            kids[s["name"]].append(s)
    for s in found:
        assert s["host_start_us"] <= s["host_end_us"]
        assert s["device_start_us"] is None and s["device_end_us"] is None
        if s is not root:
            assert root["host_start_us"] <= s["host_start_us"]
            assert s["host_end_us"] <= root["host_end_us"]
    return root, dict(kids)


@pytest.mark.parametrize("name", ["fused", "farm", "compiled", "eager"])
def test_nothing_is_kept_with_recording_off(fused_target, sweep_target,
                                            name):
    """No profiler and no recording(): no span is kept, and a span site
    is the shared no-op."""
    _runners(fused_target, sweep_target)[name]()
    assert profiling.spans() == []
    assert profiling.span("chain.replay", steps=1) is profiling.span("x")


def test_capture_s_counts_with_recording_off(sweep_target):
    """capture_s adds the first run's capture, once a chain, recording or
    not; launches is the kernels' own dict, a family of the counters."""
    assert profiling.counters["launches"] is launches
    chain = _chain(sweep_target)
    before = profiling.counters["capture_s"]
    chain.run(_gen(), THETA0, 5)
    after = profiling.counters["capture_s"]
    assert after > before
    chain.run(_gen(), THETA0, 5)
    assert profiling.counters["capture_s"] == after
    assert profiling.spans() == []


@pytest.mark.parametrize("num_steps,unroll", [(7, 3), (10, 1), (4, 4)])
def test_compiled_chain_span_tree(sweep_target, num_steps, unroll):
    """A CompiledChain(capture=False) run: chain.run holds chain.capture
    on the first run only, a chain.replay a chunk whose steps sum to
    num_steps (with step 0 in the capture), and a chain.records after each
    replay (and after step 0)."""
    chain = _chain(sweep_target, unroll)
    for first in (True, False):
        profiling.reset()
        with profiling.recording():
            chain.run(_gen(), THETA0, num_steps)
        root, kids = _tree(profiling.spans())
        assert root["name"] == "chain.run"
        assert root["attrs"] == {"steps": num_steps}
        replays = kids["chain.replay"]
        assert sum(s["attrs"]["steps"] for s in replays) == (
            num_steps - first)
        assert all(s["attrs"]["steps"] in (1, unroll) for s in replays)
        assert len(kids["chain.records"]) == len(replays) + first
        assert len(kids.get("chain.capture", [])) == first
        assert set(kids) <= {"chain.capture", "chain.replay",
                             "chain.records"}


def test_eager_chain_span_tree(sweep_target):
    """run_chain_eager: chain.run holds a chain.replay a superstep and one
    chain.records."""
    sup = pmp.make_superstep(sweep_target, CFG)
    with profiling.recording():
        base.run_chain_eager(sup, _gen(), THETA0, 6)
    root, kids = _tree(profiling.spans())
    assert root["name"] == "chain.run" and root["attrs"] == {"steps": 6}
    assert [s["attrs"] for s in kids["chain.replay"]] == [{"steps": 1}] * 6
    assert len(kids["chain.records"]) == 1 and set(kids) == {
        "chain.replay", "chain.records"}


@pytest.mark.parametrize("steps,chunk", [(20, 8), (16, 8), (5, 8)])
def test_fused_chain_span_tree(fused_target, steps, chunk):
    """make_fused_chain on the CPU (rng="kernel" draws uniforms from the
    generator there): fused.run holds a fused.seeds and a fused.kernel of
    `chunk` steps a chunk, then one fused.gather."""
    run = fc.make_fused_chain(fused_target, CFG, chunk=chunk, rng="kernel")
    with profiling.recording():
        run(_gen(), THETA0, steps)
    found = profiling.spans()
    root, kids = _tree(found)
    n_chunks = -(-steps // chunk)
    assert root["name"] == "fused.run" and root["attrs"] == {"steps": steps}
    assert [s["attrs"] for s in kids["fused.kernel"]] == [
        {"steps": chunk}] * n_chunks
    assert len(kids["fused.seeds"]) == n_chunks
    assert len(kids["fused.gather"]) == 1
    assert set(kids) == {"fused.seeds", "fused.kernel", "fused.gather"}
    names = [s["name"] for s in found]
    assert names[-2:] == ["fused.gather", "fused.run"]


@pytest.mark.parametrize("C", [1, 3])
def test_farm_span_tree(fused_target, C):
    """make_chain_farm_fused on the CPU: farm.run (with chains where
    there are several) holds a farm.seeds and a farm.kernel a chunk, and
    one farm.gather."""
    farm = chains.make_chain_farm_fused(fused_target, CFG, 20, chunk=8)
    th = THETA0 + 0.1 * torch.arange(C, dtype=torch.float32)[:, None]
    with profiling.recording():
        farm(chains.chain_generators(5, C, "cpu"), th)
    root, kids = _tree(profiling.spans())
    many = {"chains": C} if C > 1 else {}
    assert root["name"] == "farm.run"
    assert root["attrs"] == {"steps": 20, **many}
    assert [s["attrs"] for s in kids["farm.kernel"]] == [
        {"steps": 8, **many}] * 3
    assert len(kids["farm.seeds"]) == 3 and len(kids["farm.gather"]) == 1
    assert set(kids) == {"farm.seeds", "farm.kernel", "farm.gather"}


def test_spans_and_reset(sweep_target):
    """spans() is a snapshot that does not clear; reset() clears; nested
    recording() blocks keep recording until the outer one ends."""
    chain = _chain(sweep_target)
    with profiling.recording():
        with profiling.recording():
            chain.run(_gen(), THETA0, 4)
        chain.run(_gen(), THETA0, 4)
    chain.run(_gen(), THETA0, 4)
    first = profiling.spans()
    assert [s["name"] for s in first].count("chain.run") == 2
    first[0]["name"] = "changed"
    assert profiling.spans()[0]["name"] != "changed"
    assert len(profiling.spans()) == len(first)
    profiling.reset()
    assert profiling.spans() == []


@pytest.mark.parametrize("name", ["fused", "farm", "compiled", "eager"])
def test_spans_are_user_annotations_on_the_trace_clock(
        fused_target, sweep_target, tmp_path, name):
    """Under torch.profiler (profiling.trace) spans are kept without
    recording(); each is a user_annotation event of the Chrome trace, and
    its host start, less the trace's baseTimeNanoseconds, is the event's
    ts within 1 ms."""
    run = _runners(fused_target, sweep_target)[name]
    with profiling.trace(str(tmp_path)):
        run()
    found = profiling.spans()
    assert found
    path = sorted(glob.glob(str(tmp_path / "trace_*.json")))[-1]
    with open(path) as f:
        trace = json.load(f)
    base_us = trace["baseTimeNanoseconds"] / 1e3
    events = collections.defaultdict(list)
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation":
            events[e["name"]].append(float(e["ts"]))
    for span_name in {s["name"] for s in found}:
        mine = sorted(s["host_start_us"] - base_us for s in found
                      if s["name"] == span_name)
        theirs = sorted(events[span_name])
        assert len(mine) == len(theirs), span_name
        for a, b in zip(mine, theirs):
            assert abs(a - b) < 1000.0, (span_name, a, b)


@pytest.mark.parametrize("name", ["fused", "farm", "compiled", "eager"])
def test_draws_bit_equal_with_recording_on_and_off(
        fused_target, sweep_target, name):
    run = _runners(fused_target, sweep_target)[name]
    off = run()
    with profiling.recording():
        on = run()
    assert profiling.spans()
    la, lb = base._leaves(off), base._leaves(on)
    assert len(la) == len(lb)
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
