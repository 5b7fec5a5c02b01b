"""EX1b: 2-D banana-distribution sampling (SP/MP/PMP) + hist2d artifact
(port of ``pmpx/experiments/banana.py``).

Parity with ``simple_sampling/error/banana/banana_data.ipynb``: the notebook
plots precomputed SP/MP/PMP sample dumps against the analytic density
``exp(-x1^2/2 - (x2 - 2(x1^2 - 5))^2/2)``.  The sampler scripts that made
those dumps are not in the reference repo; this module is the missing
generator plus the visual-comparison artifact.
"""

from __future__ import annotations

import numpy as np
import torch

from pmpx_torch._device import resolve_device
from pmpx_torch.config import SamplerSpec
from pmpx_torch.experiments._common import collect_samples, maybe_plot, seeded
from pmpx_torch.metrics.recorder import save_trace
from pmpx_torch.targets import Banana


def run(
    num_steps: int = 5000,
    N: int = 7,
    deep: int = 2,
    step_size: float = 0.7,
    seed: int = 0,
    out_dir: str = "results/banana",
    scale: str = "smoke",
    device=None,
):
    dev = resolve_device(device)
    if scale == "paper":
        num_steps = 50000
    target = Banana()
    specs = {
        "SP": SamplerSpec(algo="mh", step_size=step_size, rule="barker"),
        "MP": SamplerSpec(algo="mp", N=N, step_size=step_size),
        "PMP": SamplerSpec(algo="pmp", N=N, depth=deep, step_size=step_size),
    }
    theta0 = torch.tensor([0.0, -8.0], device=dev)
    out = {}
    arrays = {}
    for name, spec in specs.items():
        superstep = spec.build(target)
        s = collect_samples(superstep, seeded(seed, dev), theta0, num_steps)
        arrays[name] = s
        out[f"{name}_x1_mean"] = float(s[:, 0].mean())
        out[f"{name}_x2_mean"] = float(s[:, 1].mean())
    save_trace(out_dir, "banana_samples", arrays, {"steps": num_steps})

    def plot(plt):
        fig, axes = plt.subplots(1, 4, figsize=(16, 4))
        g = np.mgrid[-4:4:0.05, -14:4:0.05]
        dens = np.exp(-0.5 * g[0] ** 2) * np.exp(
            -0.5 * (g[1] - 2 * (g[0] ** 2 - 5)) ** 2
        )
        axes[0].contourf(g[0], g[1], dens, 30)
        axes[0].set_title("analytic")
        for ax, name in zip(axes[1:], ("SP", "MP", "PMP")):
            s = arrays[name]
            ax.hist2d(
                s[:, 0], s[:, 1], bins=80,
                range=[[-4, 4], [-14, 4]],
            )
            ax.set_title(name)
        fig.savefig(f"{out_dir}/banana.pdf")

    maybe_plot(plot)
    return out
