"""Figure rendering from saved experiment artifacts (port of
``pmpx/experiments/plots.py``; NumPy and matplotlib only).

Produces the reference's comparison figures (``ess_compare.pdf``,
``msjd_compare.pdf``, ``conv_iter_and_time.pdf``) from the experiments'
outputs — the offline-notebook layer of the reference, as one module.
Each returns None when matplotlib is not importable.
"""

from __future__ import annotations

import json
import os

import numpy as np

from pmpx_torch.experiments._common import maybe_plot

__all__ = ["render_ess_msjd", "render_convergence"]


def render_ess_msjd(summary_json: str, out_dir: str):
    """ess_compare.pdf / msjd_compare.pdf from an ess_msjd run summary."""
    with open(summary_json) as f:
        data = json.load(f)
    series = {}
    for k, v in data.items():
        if not k.endswith(("_ess_per_s", "_msjd_per_s")):
            continue
        algo, P, metric = k.split("_", 2)
        if metric.startswith("all_"):
            # the emit-all estimator family (trace="all") plots as its
            # own series next to the root-path one
            algo, metric = algo + "-all", metric[len("all_"):]
        series.setdefault((algo, metric), []).append((int(P[1:]), v))
    os.makedirs(out_dir, exist_ok=True)

    def plot(plt):
        for metric, fname in (
            ("ess_per_s", "ess_compare.pdf"),
            ("msjd_per_s", "msjd_compare.pdf"),
        ):
            fig = plt.figure()
            for (algo, m), pts in sorted(series.items()):
                if m != metric:
                    continue
                pts = sorted(pts)
                plt.plot(
                    [p for p, _ in pts],
                    [v for _, v in pts],
                    marker="o",
                    label=algo.upper(),
                )
            plt.xscale("log", base=2)
            plt.xlabel("parallelism P")
            plt.ylabel(metric.replace("_", "/"))
            if plt.gca().get_legend_handles_labels()[0]:
                plt.legend()
            fig.savefig(os.path.join(out_dir, fname))
            plt.close(fig)
        return True

    return maybe_plot(plot)


def render_convergence(npz_path: str, out_dir: str):
    """conv_iter_and_time.pdf: parameter traces vs iteration and wall-clock
    (par_conv_analy.ipynb's figure)."""
    z = np.load(npz_path)
    algos = sorted(
        {k.rsplit("_", 1)[0] for k in z.files if k.endswith("_params")}
    )
    os.makedirs(out_dir, exist_ok=True)

    def plot(plt):
        fig, axes = plt.subplots(2, 3, figsize=(14, 6))
        names = ["beta0", "beta1", "sigma"]
        truths = [-1.0, 2.0, 0.5]
        for j, (name, tr) in enumerate(zip(names, truths)):
            for algo in algos:
                p = z[f"{algo}_params"]
                t = z[f"{algo}_time"]
                val = np.abs(p[:, j]) if name == "sigma" else p[:, j]
                axes[0][j].plot(val, label=algo)
                axes[1][j].plot(t, val, label=algo)
            for ax in (axes[0][j], axes[1][j]):
                ax.axhline(tr, color="k", lw=0.5)
            axes[0][j].set_title(name)
            axes[1][j].set_xlabel("seconds")
        axes[0][0].set_ylabel("vs iteration")
        axes[1][0].set_ylabel("vs wall-clock")
        axes[0][0].legend()
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "conv_iter_and_time.pdf"))
        plt.close(fig)
        return True

    return maybe_plot(plot)
