"""The benchmark cell of ``bench.py`` (repo root) on the port: a PMP chain
over the Bayesian linreg posterior, n = 100,000 points, temper 1e-3, a
binary prefetch tree with N = 1, depth = 10 (P = 1024 speculative states),
step 0.02, transition sigma 1.0, ``selection="all_first"``, theta0 =
(0, 0, 1).  Two paths run the same sampler:

* ``sweep`` — :func:`pmpx_torch.run_chain` over the PMP superstep, with
  the O(P*n) likelihood in the ``linreg_rss`` CUDA kernel;
* ``fused`` — the whole chain in the ``fused_chain`` CUDA kernel, 1000
  supersteps per launch, uniforms from its in-kernel Philox.

Both are timed with CUDA events after a warm-up.  Run
``python -m pmpx_torch.bench`` on a machine with a CUDA card; it prints
one JSON line (``--profile`` first prints a torch.profiler breakdown of
each path).  The A100 figure of the reference implementation
(42096.793 us GPU + 2041.279 us host per iteration) is printed beside the
card's numbers as that: the reference's, on an A100.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import tempfile
import time

import torch

from pmpx_torch import _build
from pmpx_torch._device import resolve_device
from pmpx_torch.kernels import fused_chain as fc
from pmpx_torch.samplers import pmp
from pmpx_torch.samplers.base import run_chain
from pmpx_torch.targets.linreg import BayesLinReg, make_synthetic_linreg

__all__ = [
    "A100_REFERENCE_US", "bench_target", "bench_config", "theta0",
    "time_sweep", "time_fused", "least_squares", "profile_path", "main",
]

A100_REFERENCE_US = 42096.793 + 2041.279
N_DATA = 100_000
TEMPER = 1e-3
DEPTH = 10
SWEEP_ITERS = 2000
FUSED_ITERS = 100_000
FUSED_CHUNK = 1000


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


def time_sweep(target, cfg, *, before_timed=None):
    """The sweep path: ``run_chain`` over ``make_superstep``, 20 supersteps
    of warm-up, then ``SWEEP_ITERS`` timed.  Returns ``(us_per_iter,
    trace (SWEEP_ITERS, 3))``.  ``before_timed()`` runs just before the
    timed run."""
    superstep = pmp.make_superstep(target, cfg)
    gen = torch.Generator(device=target.device)
    gen.manual_seed(1)
    th0 = theta0(target.device)
    run_chain(superstep, gen, th0, 20, collect=lambda t, o: t)
    torch.cuda.synchronize()
    if before_timed is not None:
        before_timed()
    (_, trace), ms = _elapsed_ms(lambda: run_chain(
        superstep, gen, th0, SWEEP_ITERS, collect=lambda t, o: t))
    return ms * 1e3 / SWEEP_ITERS, trace


def time_fused(target, cfg, *, before_timed=None):
    """The fused path: ``make_fused_chain(rng="kernel")`` in launches of
    ``FUSED_CHUNK`` supersteps, one launch of warm-up, then
    ``FUSED_ITERS`` timed.  Returns ``(us_per_iter, trace (FUSED_ITERS,
    3))``."""
    run = fc.make_fused_chain(target, cfg, chunk=FUSED_CHUNK, rng="kernel")
    gen = torch.Generator(device=target.device)
    gen.manual_seed(2)
    th0 = theta0(target.device)
    run(gen, th0, FUSED_CHUNK)
    torch.cuda.synchronize()
    if before_timed is not None:
        before_timed()
    trace, ms = _elapsed_ms(lambda: run(gen, th0, FUSED_ITERS))
    return ms * 1e3 / FUSED_ITERS, trace


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
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


def _own_kernels() -> set:
    """The names of the ``__global__`` functions in ``pmpx_torch/csrc``."""
    return {name for src in sorted(_build.CSRC.glob("*.cu"))
            for name in _GLOBAL.findall(src.read_text())}


def profile_path(fn) -> dict:
    """Where the time of ``fn()`` goes on the card, from a
    ``torch.profiler`` trace: the kernels launched (count, summed device
    time, the five largest by time), the span from the first kernel's start
    to the last one's end, the host wall time, and the device's idle share
    of the span."""
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
    span = (max(e["ts"] + e["dur"] for e in kernels)
            - min(e["ts"] for e in kernels))
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
        "kernels": len(kernels), "device_busy_us": busy, "span_us": span,
        "wall_us": wall_us, "idle_share": 1.0 - busy / span,
        "top": [{"name": n[:80], "us": us} for n, us in top],
        # the port's own kernels (pmpx_torch/csrc keeps them in anonymous
        # namespaces, as PyTorch keeps some of its own)
        "own": own,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m pmpx_torch.bench")
    parser.add_argument(
        "--profile", action="store_true",
        help="also trace 20 sweep supersteps and one fused launch of "
             "the cell, of flat MP (P = 1024) and of the N = 7 x depth 3 "
             "tree with torch.profiler and print where the time goes")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pmpx_torch.bench: no CUDA device")
    t0 = time.perf_counter()
    target = bench_target()
    cfg = bench_config()
    sweep_us, _ = time_sweep(target, cfg)
    fused_us, _ = time_fused(target, cfg)
    if args.profile:
        gen = torch.Generator(device=target.device)
        gen.manual_seed(4)
        th0 = theta0(target.device)
        # the cell's binary tree, and the time grid's flat MP (P = 1024)
        # and conv_pmp tree (N = 7, depth 3) on the same data
        cfgs = {"": cfg, "_mp": pmp.PMPConfig(
            N=1023, depth=1, step_size=0.02, selection="all_first"),
            "_general": pmp.PMPConfig(
                N=7, depth=3, step_size=0.02, selection="all_first")}
        paths = []
        for tag, c in cfgs.items():
            sup = pmp.make_superstep(target, c)
            run = fc.make_fused_chain(target, c, chunk=FUSED_CHUNK)
            paths += [
                (f"sweep{tag}", lambda s=sup: run_chain(
                    s, gen, th0, 20, collect=lambda t, o: t), 20),
                (f"fused{tag}", lambda r=run: r(gen, th0, FUSED_CHUNK),
                 FUSED_CHUNK),
            ]
        for name, fn, iters in paths:
            fn()  # warm-up outside the trace
            prof = profile_path(fn)
            prof["supersteps"] = iters
            print(json.dumps({"profile": name, **prof}))
    print(json.dumps({
        "metric": "pmp_p1024_n100k_fused_us_per_iter",
        "value": fused_us,
        "unit": "us",
        "sweep_us_per_iter": sweep_us,
        "device": torch.cuda.get_device_name(0),
        "a100_reference_us_per_iter": A100_REFERENCE_US,
        "wall_s": time.perf_counter() - t0,
    }))


if __name__ == "__main__":
    main()
