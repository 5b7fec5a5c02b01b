"""Convergence vs. parallelism P with a wall-clock budget (port of
``pmpx/experiments/cores_sweep.py``).

Parity with the reference's
``simple_net/MP_and_PMP_Convergence_with_Cores/convery_time_*.cu``: MP
(N = P - 1) and binary-tree PMP run until a wall-clock budget
(``set_time``, 180 s at ``scale="paper"``) expires, and the parameter
error is compared at equal wall-clock across P.  The budget check lives
on the host between calls; a call runs ``chunk`` supersteps of
``run_chain`` or, with ``method="fused_chain"``, ``fused_call_steps``
supersteps as ``chunk``-sized kernel launches that never wait on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pmpx_torch import tree
from pmpx_torch._device import resolve_device
from pmpx_torch.config import SamplerSpec
from pmpx_torch.experiments._common import as_tuple, sync
from pmpx_torch.metrics.recorder import save_trace
from pmpx_torch.samplers.base import run_chain
from pmpx_torch.targets.linreg import BayesLinReg, make_synthetic_linreg

TRUE = np.array([-1.0, 2.0, 0.5])


def run(
    n_data: int = 100000,
    Ps=(4, 16, 64, 256, 1024),
    set_time: float = 5.0,
    chunk: int = 200,
    algo: str = "pmp",
    fused_call_steps: int = 100_000,
    seed: int = 0,
    out_dir: str = "results/cores",
    scale: str = "smoke",
    method: str = "auto",
    device=None,
):
    dev = resolve_device(device)
    Ps = as_tuple(Ps)
    if scale == "paper":
        set_time = 180.0
    fused_chain = method == "fused_chain"
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x, y = make_synthetic_linreg(g, n_data)
    target = BayesLinReg(
        x, y, temper=1.0 / 2000.0,
        method="fused" if fused_chain else method, device=dev,
    )
    theta0 = torch.tensor([0.0, 0.0, 1.0], device=dev)
    out, traces = {}, {}
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
        if fused_chain:
            from pmpx_torch.kernels import fused_chain as fc

            call_steps = max(chunk, fused_call_steps)
            runk = fc.make_fused_chain(
                target, fc.spec_to_cfg(spec), chunk=min(chunk, 1000)
            )

            def f(gen, t, r=runk, c=call_steps):
                tr = r(gen, t, c)
                return tr[-1], tr

            chunk_iters = call_steps
        else:
            chunk_iters = chunk
            superstep = spec.build(target)

            def f(gen, t, s=superstep):
                return run_chain(s, gen, t, chunk, collect=lambda th, o: th)

        theta = theta0
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)
        f(gen, theta)  # warm-up (and the kernels' build) outside the budget
        sync(dev)
        iters = 0
        t0 = time.perf_counter()
        last = None
        while time.perf_counter() - t0 < set_time:
            theta, roots = f(gen, theta)
            last = roots.cpu().numpy()
            iters += chunk_iters
        err = (
            float(np.abs(np.abs(last[-chunk // 2:]) - np.abs(TRUE)).mean())
            if last is not None
            else float("nan")
        )
        out[f"P{P}_iters"] = iters
        out[f"P{P}_err"] = err
        traces[f"P{P}_tail"] = last if last is not None else np.zeros((0, 3))
    save_trace(out_dir, f"cores_{algo}", traces, {"set_time": set_time})
    return out
