"""The linreg cell of ``bench.py`` (repo root) on the port, and card-side
helpers that time and count a call, for ``chip_smoke.py``,
``scripts/rss_cluster_fit.py`` and the tests.

The cell: a PMP chain over the Bayesian linreg posterior, n = 100,000
points, temper 1e-3, a binary prefetch tree with N = 1, depth = 10 (P =
1024 speculative states), step 0.02, transition sigma 1.0,
``selection="all_first"``, theta0 = (0, 0, 1).  The benchmark measures
it: ``python3 benchmark/run.py --workload linreg-p1024-sweep`` (the PMP
superstep as one compiled chain) and ``--workload linreg-p1024-fused``
(the whole chain in the ``fused_chain`` kernel).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import tempfile
import time

import torch

from pmpx_torch import _build
from pmpx_torch._device import resolve_device
from pmpx_torch.kernels.linreg import batched_rss, pad_proposals
from pmpx_torch.samplers import pmp
from pmpx_torch.targets.linreg import BayesLinReg, make_synthetic_linreg

__all__ = [
    "bench_target", "bench_config", "theta0", "least_squares",
    "profile_path", "graph_us", "graph_nodes", "rss_inputs", "rss_times",
]

N_DATA = 100_000
TEMPER = 1e-3
DEPTH = 10
RSS_CALLS = 200  # calls per graph, per eager run and per profiler trace
RSS_HOST_CALLS = 1000  # calls in the host's count


def bench_config() -> pmp.PMPConfig:
    return pmp.PMPConfig(
        N=1, depth=DEPTH, step_size=0.02, trans_sigma=1.0,
        selection="all_first",
    )


def bench_target(device=None) -> BayesLinReg:
    """The cell's target over synthetic data made on ``device`` from seed
    0 (a torch stream: not the data ``bench.py`` draws)."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(0)
    x, y = make_synthetic_linreg(gen, N_DATA)
    return BayesLinReg(x, y, temper=TEMPER, method="sweep",
                       device=gen.device)


def theta0(device) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 1.0], device=device)


def _elapsed_ms(fn):
    """Run fn() between two CUDA events; (result, ms on the card)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _theta(theta, out):
    """A chain's ``collect`` that records its state."""
    return theta


def least_squares(target):
    """(b0, b1) of the least-squares fit and their posterior sd under the
    tempered likelihood, sigma at its least-squares estimate (float64)."""
    x, y = target.x.double(), target.y.double()
    X = torch.stack([torch.ones_like(x), x], dim=1)
    beta = torch.linalg.solve(X.T @ X, X.T @ y)
    resid = y - X @ beta
    s2 = (resid @ resid) / target.n
    cov = s2 / target.temper * torch.linalg.inv(X.T @ X)
    return beta.cpu(), cov.diagonal().sqrt().cpu()


_OWN = "(anonymous namespace)::"
_CU_GRAPH_NODE_TYPE_KERNEL = 0  # CUgraphNodeType
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


def _own_kernels() -> set:
    """The names of the ``__global__`` functions in ``pmpx_torch/csrc``."""
    return {name for src in sorted(_build.CSRC.glob("*.cu"))
            for name in _GLOBAL.findall(src.read_text())}


def profile_path(fn) -> dict:
    """Where the time of ``fn()`` goes on the card, from a
    ``torch.profiler`` trace: the kernels launched (count, summed device
    time, the five largest by time, the port's own) and the host wall time.
    The trace gives no idle share: the profiler stretches graph replays;
    the runners' spans (:mod:`pmpx_torch.profiling`) time the card
    untraced."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise RuntimeError("the profiler saw no kernel on the card")
    busy = sum(e["dur"] for e in kernels)
    by_name: dict = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    mine = _own_kernels()
    own = {}
    for n, us in by_name.items():
        n = n.removeprefix("void ")
        if n.startswith(_OWN):
            base = n[len(_OWN):].split("(")[0]
            if base.split("<")[0] in mine:
                own[base] = us
    return {
        "kernels": len(kernels), "device_busy_us": busy,
        "wall_us": wall_us,
        "top": [{"name": n[:80], "us": us} for n, us in top],
        # the port's own kernels (pmpx_torch/csrc keeps them in anonymous
        # namespaces, as PyTorch keeps some of its own)
        "own": own,
    }


def graph_us(call) -> float:
    """µs of one ``call()`` on the card: RSS_CALLS calls captured in one
    CUDA graph and replayed between two CUDA events."""
    call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()  # warm-up on a side stream, as graph capture asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(RSS_CALLS):
            call()
    graph.replay()
    torch.cuda.synchronize()
    _, ms = _elapsed_ms(graph.replay)
    return ms * 1e3 / RSS_CALLS


def graph_nodes(call) -> dict:
    """What one ``call()`` puts on its stream, read from the node list of a
    CUDA graph of it (the driver's ``cuGraphGetNodes``): ``kernels``, its
    kernel nodes, and ``other``, every other node (copies, memsets,
    events).  Exact where a profiler trace may drop an activity record."""
    cu = ctypes.CDLL("libcuda.so.1")
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        call()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(count)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if count.value and cu.cuGraphGetNodes(raw, nodes, ctypes.byref(count)):
        raise RuntimeError("cuGraphGetNodes failed")
    kernels = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == _CU_GRAPH_NODE_TYPE_KERNEL
    return {"kernels": kernels, "other": count.value - kernels}


def rss_times(b0, b1, x2d, y2d, **kw) -> dict:
    """Times of one ``batched_rss(b0, b1, x2d, y2d, **kw)`` call on the
    card, in µs: ``device_us``, RSS_CALLS calls captured in one CUDA graph
    and replayed between two CUDA events (the device's time, launch gaps
    included, with no host in the way); ``busy_us`` and
    ``traced_kernels_per_call``, the port's own kernels' summed durations
    and the kernels' count in a torch.profiler trace of RSS_CALLS eager
    calls (a trace may drop a record); ``kernels_per_call`` and
    ``other_nodes_per_call``, exact, from :func:`graph_nodes`; ``eager_us``,
    RSS_CALLS eager calls between two CUDA events (the pace the host's
    wrapper sets when it is slower than the card); ``host_us``, the host's
    clock around RSS_HOST_CALLS calls with no synchronisation."""

    def call():
        return batched_rss(b0, b1, x2d, y2d, **kw)

    def calls():
        for _ in range(RSS_CALLS):
            call()

    call()
    torch.cuda.synchronize()
    _, eager_ms = _elapsed_ms(calls)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RSS_HOST_CALLS):
        call()
    host_us = (time.perf_counter() - t0) * 1e6 / RSS_HOST_CALLS
    torch.cuda.synchronize()
    device_us = graph_us(call)
    nodes = graph_nodes(call)
    prof = profile_path(calls)
    return {
        "device_us": device_us,
        "busy_us": sum(prof["own"].values()) / RSS_CALLS,
        "kernels_per_call": nodes["kernels"],
        "other_nodes_per_call": nodes["other"],
        "traced_kernels_per_call": prof["kernels"] / RSS_CALLS,
        "own_kernels": sorted(prof["own"]),
        "eager_us": eager_ms * 1e3 / RSS_CALLS,
        "host_us": host_us,
    }


def rss_inputs(P, n, device):
    """The target over n synthetic points and P proposals around the
    posterior, padded as ``batched_rss`` takes them (seed 100 + P)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(100 + P)
    x, y = make_synthetic_linreg(gen, n)
    t = BayesLinReg(x, y, method="sweep", device=device)
    b0, b1, _ = pad_proposals(
        -1.0 + 0.3 * torch.randn(P, generator=gen, device=device),
        2.0 + 0.3 * torch.randn(P, generator=gen, device=device))
    return t, b0, b1
