"""Convergence benchmark: MH vs MP vs PMP beta-traces with per-iteration
wall-clock logging (port of ``pmpx/experiments/convergence.py``).

Parity with ``simple_net/MH_MP_PMP_Compare_convergence/conv_{mh,mp,pmp}.cu``:
100k-point linreg data, tempering /2000 (``conv_mp.cu:19``), MP with N=7,
PMP with 512 states (N_step=7, depth=3, ``conv_pmp.cu:85-88``), per-iteration
beta0/beta1/sigma/time streams.  The reference writes txt per iteration from
the host loop; here the chain runs on the device and the trace is saved
once (cumulative per-iteration times are reconstructed from the total,
which is exact in the steady state since every superstep runs the same
kernels).  Each algorithm's timed run follows a warm-up run of the same
length (``pmpx``'s compile call), each clock read after a device sync.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from pmpx_torch import runtime
from pmpx_torch._device import resolve_device
from pmpx_torch.config import SamplerSpec
from pmpx_torch.experiments._common import device_name, seeded, sync
from pmpx_torch.metrics.recorder import save_trace
from pmpx_torch.samplers.base import compile_chain
from pmpx_torch.targets.linreg import BayesLinReg, make_synthetic_linreg


def load_reference_data(data_dir: str, device=None):
    """Load the reference's committed 100k-point dataset (the exact bytes
    behind every CUDA convergence/timing number): ``data_x.txt`` /
    ``data_y.txt`` as read by ``conv_mp.cu:62-79`` (space-separated floats,
    single line).  Parsed with the native runtime's mmap float reader;
    float32 tensors on ``device`` (CUDA unless given)."""
    dev = resolve_device(device)
    x = runtime.read_floats(os.path.join(data_dir, "data_x.txt"))
    y = runtime.read_floats(os.path.join(data_dir, "data_y.txt"))
    if x.shape != y.shape or x.size == 0:
        raise ValueError(
            f"bad reference dataset in {data_dir}: x{x.shape} y{y.shape}"
        )
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def run(
    n_data: int = 100000,
    num_steps: int = 500,
    temper: float = 1.0 / 2000.0,
    seed: int = 0,
    out_dir: str = "results/convergence",
    scale: str = "smoke",
    # "auto" = the sufficient statistics; "sweep" (pmpx's "pallas" and
    # "xla") = the linreg_rss kernel
    method: str = "auto",
    algos=("MH", "MP", "PMP"),
    data_dir: str = "",
    device=None,
):
    dev = resolve_device(device)
    if scale == "paper":
        num_steps = 3000  # conv_mp.cu num_steps
    if data_dir:
        x, y = load_reference_data(data_dir, device=dev)
        n_data = int(x.shape[0])
    else:
        x, y = make_synthetic_linreg(seeded(seed, dev), n_data)
    target = BayesLinReg(x, y, temper=temper, method=method, device=dev)
    theta0 = torch.tensor([0.0, 0.0, 1.0], device=dev)
    specs = {
        "MH": SamplerSpec(algo="mh", step_size=0.02),
        "MP": SamplerSpec(
            algo="mp", N=7, step_size=0.02, selection="all_first"
        ),
        "PMP": SamplerSpec(
            algo="pmp", N=7, depth=3, step_size=0.02,
            selection="all_first",
        ),
    }
    traces, out = {}, {}
    for name in algos:
        # the chain state per iteration, from one compiled chain
        compiled = compile_chain(specs[name].build(target), seeded(seed, dev),
                                 theta0, lambda th, o: th)

        def chain(c=compiled):
            return c.run(seeded(seed + 1, dev), theta0, num_steps)[1]

        chain()  # warm-up (the capture)
        sync(dev)
        t0 = time.perf_counter()
        roots = chain()
        sync(dev)
        dt = time.perf_counter() - t0
        r = roots.cpu().numpy()
        traces[f"{name}_params"] = r
        traces[f"{name}_time"] = np.linspace(
            dt / num_steps, dt, num_steps
        )
        tail = r[num_steps // 2:]
        out[f"{name}_us_per_iter"] = dt / num_steps * 1e6
        out[f"{name}_beta0"] = float(tail[:, 0].mean())
        out[f"{name}_beta1"] = float(tail[:, 1].mean())
        out[f"{name}_sigma"] = float(np.abs(tail[:, 2]).mean())
    save_trace(out_dir, "convergence", traces,
               {"n_data": n_data, "device": device_name(dev)})
    return out
