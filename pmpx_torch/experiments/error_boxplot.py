"""EX1: repeated-run error boxplots of SP vs MP vs PMP on N(0, 1) (port of
``pmpx/experiments/error_boxplot.py``).

Protocol parity with ``simple_sampling/error/error.py:191-214``: ``times``
repetitions; per repetition run each sampler for ``number_sample``
supersteps from theta0 ~ U(-1, 1) and record the post-burn-in mean
estimate; the spread of the mean estimates is the "error".  (The
reference runs times=20, number_sample=10 and plots a boxplot to
``error.pdf``.)  Every draw, theta0's included, comes from the run's one
generator.
"""

from __future__ import annotations

import numpy as np
import torch

from pmpx_torch._device import resolve_device
from pmpx_torch.config import SamplerSpec
from pmpx_torch.experiments._common import collect_samples, maybe_plot, seeded
from pmpx_torch.metrics.recorder import save_trace
from pmpx_torch.targets import Gaussian1D


def run(
    times: int = 20,
    number_sample: int = 200,
    N: int = 7,
    deep: int = 2,
    step_size: float = 1.0,
    seed: int = 0,
    out_dir: str = "results/error",
    scale: str = "smoke",
    device=None,
):
    dev = resolve_device(device)
    if scale == "paper":
        times, number_sample = 20, 1000
    target = Gaussian1D(mu=0.0, sigma=1.0)
    specs = {
        # SP parity: uniform(-0.25, 0.25) proposal + Barker accept
        # (error.py:27-31)
        "SP": SamplerSpec(
            algo="mh", step_size=0.25, rule="barker", proposal="uniform"
        ),
        "MP": SamplerSpec(algo="mp", N=N, step_size=step_size),
        "PMP": SamplerSpec(
            algo="pmp", N=N, depth=deep, step_size=step_size
        ),
    }
    supersteps = {name: spec.build(target) for name, spec in specs.items()}
    means = {k: [] for k in specs}
    gen = seeded(seed, dev)
    for _ in range(times):
        for name, superstep in supersteps.items():
            theta0 = 2.0 * torch.rand((1,), generator=gen, device=dev) - 1.0
            s = collect_samples(superstep, gen, theta0, number_sample)
            means[name].append(float(s.mean()))
    arrays = {k: np.asarray(v) for k, v in means.items()}
    save_trace(out_dir, "error_boxplot", arrays, {"times": times})

    def plot(plt):
        fig = plt.figure(figsize=(3, 6))
        plt.title("ERROR")
        plt.boxplot(
            [arrays[k] for k in ("SP", "MP", "PMP")],
            tick_labels=["SP", "MP", "PMP"],
        )
        fig.savefig(f"{out_dir}/error.pdf")

    maybe_plot(plot)
    return {
        f"{k}_abs_mean_err": float(np.abs(v).mean())
        for k, v in arrays.items()
    }
