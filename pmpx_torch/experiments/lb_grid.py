"""Robustness grid: step size alpha x {MH, MP, PMP} over Bayesian linreg
(port of ``pmpx/experiments/lb_grid.py``).

Parity with ``simple_net/lb.py:377-423``: alpha in {0.05, 0.1, 0.2, 0.4},
synthetic y = -1 + 2x + 0.5 eps data, tempering *50/n (``lb.py:35``),
beta0-trace plots per cell -> ``lb.pdf``.
"""

from __future__ import annotations

import torch

from pmpx_torch._device import resolve_device
from pmpx_torch.config import SamplerSpec
from pmpx_torch.experiments._common import (
    as_tuple, collect_samples, maybe_plot, seeded,
)
from pmpx_torch.metrics.recorder import save_trace
from pmpx_torch.targets.linreg import BayesLinReg, make_synthetic_linreg


def run(
    n_data: int = 10000,
    num_steps: int = 600,
    steps=(0.05, 0.1, 0.2, 0.4),
    seed: int = 0,
    out_dir: str = "results/lb",
    scale: str = "smoke",
    method: str = "auto",
    device=None,
):
    dev = resolve_device(device)
    steps = as_tuple(steps)
    if scale == "paper":
        n_data, num_steps = 100000, 2500
    x, y = make_synthetic_linreg(seeded(seed, dev), n_data)
    target = BayesLinReg(x, y, temper=50.0 / n_data, method=method,
                         device=dev)
    theta0 = torch.tensor([0.0, 0.0, 1.0], device=dev)
    traces = {}
    out = {}
    for alpha in steps:
        specs = {
            "MH": SamplerSpec(algo="mh", step_size=alpha),
            "MP": SamplerSpec(algo="mp", N=7, step_size=alpha),
            "PMP": SamplerSpec(algo="pmp", N=7, depth=2, step_size=alpha),
        }
        for name, spec in specs.items():
            superstep = spec.build(target)
            s = collect_samples(
                superstep, seeded(seed + 1, dev), theta0, num_steps,
                burn_frac=0.5,
            )
            traces[f"{name}_a{alpha}"] = s
            out[f"{name}_a{alpha}_beta0"] = float(s[:, 0].mean())
    save_trace(out_dir, "lb_grid", traces, {"alphas": list(steps)})

    def plot(plt):
        names = ["MH", "MP", "PMP"]
        fig, axes = plt.subplots(
            len(names), len(steps), figsize=(13, 6), squeeze=False
        )
        for i, name in enumerate(names):
            for j, alpha in enumerate(steps):
                tr = traces[f"{name}_a{alpha}"][:, 0]
                axes[i][j].plot(tr[-1000:])
                axes[i][j].set_ylim(-1.5, -0.5)
                if i == 0:
                    axes[i][j].set_title(f"step = {alpha}")
        fig.tight_layout()
        fig.savefig(f"{out_dir}/lb.pdf")

    maybe_plot(plot)
    return out
