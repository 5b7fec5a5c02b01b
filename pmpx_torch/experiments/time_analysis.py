"""Per-iteration time grid: {500, 100000} data x {4, 1024} parallelism
(port of ``pmpx/experiments/time_analysis.py``).

Parity with the reference's ``simple_net/MP_and_PMP_time_analysis/`` (the
README.md:39-48 table and BASELINE.md): MP and binary-tree PMP
per-iteration times, plus, with ``include_conv_pmp``, the reference's
flagship N=7 x depth=3 tree (``conv_pmp.cu:85-88``).  The reference splits
"GPU time" from "additional overhead" (host processing + H2D/D2H per
iteration); here the superstep has no host transfer, so the overhead
column is reported as 0.0, as ``pmpx`` reports it.

Each cell is timed on the host's clock: one warm-up run, then the best of
3 runs of ``iters`` supersteps, each closed by ``torch.cuda.synchronize()``
(the counterpart of ``pmpx``'s ``block_until_ready``).  The result has the
keys of ``pmpx``'s; the saved trace's manifest names the device.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pmpx_torch import tree
from pmpx_torch._device import resolve_device
from pmpx_torch.config import SamplerSpec
from pmpx_torch.experiments._common import as_tuple, sync
from pmpx_torch.kernels import fused_chain as fc
from pmpx_torch.metrics.recorder import save_trace
from pmpx_torch.samplers.base import run_chain
from pmpx_torch.targets.linreg import BayesLinReg, make_synthetic_linreg

# The reference implementation's A100 numbers (README.md:41-48), not a run
# of this code: (algo, n, P) -> (gpu_us, host_us)
REFERENCE_A100 = {
    ("mp", 500, 4): (157.505, 115.84),
    ("mp", 500, 1024): (452.258, 1066.212),
    ("mp", 100000, 4): (33465.447, 346.528),
    ("mp", 100000, 1024): (33473.53, 1099.258),
    ("pmp", 500, 4): (156.927, 65.952),
    ("pmp", 500, 1024): (177.952, 1289.7),
    ("pmp", 100000, 4): (40259.869, 538.464),
    ("pmp", 100000, 1024): (42096.793, 2041.279),
}


def _generator(device, seed):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def grid_target(n_data: int, *, seed: int = 0, method: str = "sweep",
                device=None) -> BayesLinReg:
    """The grid's target at ``n_data`` points: synthetic data drawn from
    ``seed``, temper 1/10 at n = 500 and 1/1000 otherwise."""
    dev = resolve_device(device)
    x, y = make_synthetic_linreg(_generator(dev, seed), n_data)
    temper = 1.0 / 10.0 if n_data == 500 else 1.0 / 1000.0
    return BayesLinReg(x, y, temper=temper, method=method, device=dev)


def _time_cell(target, spec, theta0, iters, fused_chain):
    """Best-of-3 per-iteration time (us) for one sampler cell; returns
    (best_us, path) where path says which implementation was timed."""
    dev = theta0.device
    cfg = fc.spec_to_cfg(spec)
    cell_method = "scan"
    if fused_chain and fc.supports(cfg):
        # whole chain chunks inside one kernel launch each
        cell_method = "fused_chain"
        runk = fc.make_fused_chain(target, cfg, chunk=min(1000, iters))

        def f(g):
            return runk(g, theta0, iters)
    else:
        superstep = spec.build(target)

        def f(g):
            return run_chain(superstep, g, theta0, iters,
                             collect=lambda th, o: o["root_index"])[1]
    f(_generator(dev, 1))
    sync(dev)
    best = float("inf")
    for r in range(3):
        g = _generator(dev, 2 + r)
        t0 = time.perf_counter()
        f(g)
        sync(dev)
        best = min(best, (time.perf_counter() - t0) / iters * 1e6)
    return best, cell_method


def run(
    data_sizes=(500, 100000),
    Ps=(4, 1024),
    iters: int = 200,
    seed: int = 0,
    out_dir: str = "results/time",
    scale: str = "smoke",
    # "sweep" = the O(P*n) linreg_rss kernel, like-for-like with the
    # reference CUDA kernels (pmpx maps it to "pallas"/"xla")
    method: str = "sweep",
    # also time the reference's flagship general-tree shape
    # (conv_pmp.cu:85-88: N_step=7, depth=3, 512 nodes) per data size
    include_conv_pmp: bool = False,
    device=None,
):
    if scale != "smoke":
        raise ValueError(f"scale {scale!r}: the time grid has only the "
                         "'smoke' scale")
    dev = resolve_device(device)
    data_sizes = as_tuple(data_sizes)
    Ps = as_tuple(Ps)
    fused_chain = method == "fused_chain"
    if fused_chain:
        method = "sweep"
    out = {}
    if fused_chain:
        # eligibility, stated up front so that the table cannot be misread
        # as covering configs the megakernel does not implement
        out["fused_eligibility"] = (
            "fused_chain covers stabilizer='none' MP/PMP cells with "
            "P <= 1024 and power-of-two tree base N+1 (incl. general "
            "(N, depth) trees such as conv_pmp's N=7 x depth=3); "
            "zscore-stabilized NN-protocol configs, non-power-of-two "
            "bases, and P > 1024 run on the scan path — per-cell "
            "*_method records which path each number timed"
        )
    rows = []
    for n_data in data_sizes:
        target = grid_target(n_data, seed=seed, method=method, device=dev)
        theta0 = torch.tensor([0.0, 0.0, 1.0], device=dev)
        cells = []
        for algo in ("mp", "pmp"):
            for P in Ps:
                if algo == "pmp":
                    spec = SamplerSpec(
                        algo="pmp", N=1, depth=tree.binary_depth(P),
                        step_size=0.02, selection="all_first",
                    )
                else:
                    spec = SamplerSpec(
                        algo="mp", N=P - 1, step_size=0.02,
                        selection="all_first",
                    )
                cells.append((algo, P, spec))
        if include_conv_pmp:
            cells.append((
                "pmp_general_N7_D3", 512,
                SamplerSpec(
                    algo="pmp", N=7, depth=3, step_size=0.02,
                    selection="all_first",
                ),
            ))
        for algo, P, spec in cells:
            best, cell_method = _time_cell(
                target, spec, theta0, iters, fused_chain
            )
            ref = REFERENCE_A100.get((algo, n_data, P))
            speedup = (
                (ref[0] + ref[1]) / best if ref is not None else None
            )
            key = f"{algo}_n{n_data}_P{P}"
            out[f"{key}_us"] = round(best, 3)
            out[f"{key}_overhead_us"] = 0.0
            if fused_chain:
                # a fused_chain request can fall back per cell; say which
                # path was timed
                out[f"{key}_method"] = cell_method
            if speedup:
                out[f"{key}_speedup_vs_a100"] = round(speedup, 2)
            rows.append((algo, n_data, P, best))
    save_trace(
        out_dir,
        "time_analysis",
        {"rows": np.asarray([r[3] for r in rows])},
        {
            "rows": [f"{r[0]}_n{r[1]}_P{r[2]}" for r in rows],
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else str(dev)),
        },
    )
    return out
