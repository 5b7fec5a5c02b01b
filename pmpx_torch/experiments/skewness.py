"""Skewness of chain-mean estimates vs. iterations (unbiasedness check;
port of ``pmpx/experiments/skewness.py``).

Parity with ``simple_net/skewness/skewness.ipynb``: over many repeated
chains, the standardized third moment of the per-chain mean estimates should
shrink toward 0 as the chain grows; the notebook computes this over the CUDA
PMP sample dumps.  Here the repetitions are one chain-batched run on the
device (:func:`pmpx_torch.parallel.run_chains_vmapped`): each superstep
evaluates all ``n_chains * P`` states in one call, on the sweep one
``linreg_rss`` launch.  Unlike ``pmpx``'s, an explicit ``num_steps`` and
``checkpoints`` win over ``scale="paper"``'s (a run at the paper's widths
with fewer steps).
"""

from __future__ import annotations

import numpy as np
import torch

from pmpx_torch import tree
from pmpx_torch._device import resolve_device
from pmpx_torch.config import SamplerSpec
from pmpx_torch.experiments._common import as_tuple, maybe_plot, seeded
from pmpx_torch.metrics import skewness
from pmpx_torch.metrics.recorder import save_trace
from pmpx_torch.parallel import run_chains_vmapped
from pmpx_torch.targets.linreg import BayesLinReg, make_synthetic_linreg


def run(
    n_data: int = 4096,
    n_chains: int = 64,
    num_steps=None,
    checkpoints=None,
    algo: str = "pmp",
    P: int = 8,
    seed: int = 0,
    out_dir: str = "results/skewness",
    scale: str = "smoke",
    method: str = "auto",
    device=None,
):
    dev = resolve_device(device)
    temper = 50.0 / n_data
    step = 0.05
    steps, marks = 400, (50, 100, 200, 400)
    if scale == "paper":
        # protocol parity: the reference's skewness notebook analyses the
        # CUDA ESS dumps (ess_per_s_*.cu: 100k data, tempering 1/2000,
        # alpha 0.02)
        n_data, steps = 100000, 100000
        marks = (5000, 20000, 50000, 100000)
        temper, step = 1.0 / 2000.0, 0.02
    num_steps = steps if num_steps is None else num_steps
    checkpoints = as_tuple(marks if checkpoints is None else checkpoints)
    x, y = make_synthetic_linreg(seeded(seed, dev), n_data)
    target = BayesLinReg(x, y, temper=temper, method=method, device=dev)
    if algo == "pmp":
        spec = SamplerSpec(
            algo="pmp", N=1, depth=tree.binary_depth(P), step_size=step,
            selection="all_first",
        )
    else:
        spec = SamplerSpec(
            algo="mp", N=P - 1, step_size=step, selection="all_first"
        )
    superstep = spec.build(target)
    theta0 = torch.tensor([0.0, 0.0, 1.0], device=dev).repeat(n_chains, 1)
    _, recs = run_chains_vmapped(
        superstep, seeded(seed + 1, dev), theta0, num_steps,
        collect=lambda th, o: th,
    )
    roots = recs.cpu().numpy()  # (chains, steps, 3)

    out = {}
    sk = []
    for c in checkpoints:
        means = roots[:, :c, 0].mean(axis=1)  # per-chain beta0 mean
        v = float(skewness(torch.from_numpy(means)))
        sk.append(v)
        out[f"skewness_at_{c}"] = v
    save_trace(
        out_dir, "skewness",
        {"roots_beta0": roots[:, :, 0], "skew": np.asarray(sk)},
        {"checkpoints": list(checkpoints)},
    )

    def plot(plt):
        fig = plt.figure()
        plt.plot(list(checkpoints), sk, marker="o")
        plt.axhline(0, color="k", lw=0.5)
        plt.xlabel("iterations")
        plt.ylabel("skewness of chain means")
        fig.savefig(f"{out_dir}/skewness.pdf")

    maybe_plot(plot)
    return out
