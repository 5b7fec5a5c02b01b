"""Build summary JSONs + plots for the port's reference-scale paper runs
(the port of ``scripts/summarize_paper.py``, with its JSON schema).

Usage: python scripts/summarize_paper_torch.py [cifar|bnn|mnist|ess|all] \
           [root]

Reads the chunked traces that ``scripts/run_paper_torch.py`` wrote under
``root`` (default ``results/paper``; the directories of
``scripts/paper_queue_torch.json``) and produces, per family:

* ``cifar``  — per-algo finals + steady timing, a twin-axis
  loss/accuracy figure per algo, and a comparison block against the
  reference's committed 50k-step CIFAR traces (read from a checkout of
  the reference at ``REF`` where one is present — data files loaded for
  comparison only).
* ``bnn``    — the 30k-step SP-vs-PMP speedup analysis
  (``MNIST_bnn_NVIDIAA100.ipynb`` cells 20-28 methodology: smoothed
  loss, first-crossing iterations, linear speedup fit) with
  steady-state ms/superstep without the first chunk, on the easy and the
  hard data.
* ``mnist``  — per-(model, algo) finals with honest step counts.
* ``ess``    — cross-path overlay of the 1M-step ESS/MSJD parallelism
  sweeps (``ess_per_s_{MP,PMP}.cu`` protocol, P grid from
  ``data_trans.py:8``): the superstep path vs the fused chain kernel on
  one axes per metric, plus a per-P fused/superstep ratio table.

Safe to re-run any time; missing traces are skipped with a note, and the
figures are skipped where matplotlib is not installed.
"""

import glob
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ROOT = "results/paper"
# a checkout of the reference implementation (absent unless placed here)
REF = os.path.join(REPO, "reference")


def _plt():
    """matplotlib's pyplot on the Agg backend, or None without it."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def _twin_plot(out_pdf, loss, test_acc, train_acc=None, title=""):
    plt = _plt()
    if plt is None:
        return
    fig, ax1 = plt.subplots(figsize=(7, 4))
    ax1.plot(loss, color="tab:red", lw=0.6, label="loss")
    ax1.set_ylabel("loss", color="tab:red")
    ax1.set_xlabel("superstep")
    ax2 = ax1.twinx()
    if train_acc is not None:
        ax2.plot(train_acc, color="tab:blue", lw=0.6, label="train acc")
    ax2.plot(test_acc, color="tab:green", lw=0.6, label="test acc")
    ax2.set_ylabel("accuracy")
    ax1.set_title(title)
    fig.legend(loc="center right")
    fig.tight_layout()
    fig.savefig(out_pdf)
    plt.close(fig)


def _meta(base):
    if os.path.exists(base + ".json"):
        with open(base + ".json") as f:
            return json.load(f)
    return {}


def cifar(out_dir=f"{ROOT}/cifar", abl_dir=f"{ROOT}/cifar_ablation"):
    res = {"protocol": (
        "reference cifar_{SP,MP,PMP}hmc.py protocol: full-batch 50000 "
        "train / 10000 test, N=7 (PMP depth 3), step 0.1, mom 0.0005, "
        "loss/train-acc/test-acc recorded every superstep; warm start "
        "from cifar_hmc's Adam pretrain (the reference's cifar.pkl is not "
        "in the repository); synthetic CIFAR stand-in at class_sep=0.35 "
        "with 5% label noise so curves stay below ceiling; bf16 compute "
        "where noted; timed on the CUDA card"
    )}
    for algo in ("sp_hmc", "mp_hmc", "pmp_hmc"):
        base = os.path.join(out_dir, f"cifar_{algo}")
        try:
            loss = np.load(base + ".loss.npy")
            tr = np.load(base + ".train_acc.npy")
            te = np.load(base + ".test_acc.npy")
        except FileNotFoundError:
            res[algo] = {"note": "trace not present (not run this round)"}
            continue
        meta = _meta(base)
        k = max(1, min(1000, len(loss) // 10))
        res[algo] = {
            "steps": int(len(loss)),
            "loss_first": float(loss[0]),
            "loss_last_1k_mean": float(loss[-k:].mean()),
            "train_acc_last_1k_mean": float(tr[-k:].mean()),
            "test_acc_last_1k_mean": float(te[-k:].mean()),
            "steady_ms_per_superstep": meta.get(
                "steady_ms_per_superstep"
            ),
        }
        _twin_plot(
            os.path.join(out_dir, f"cifar_{algo}.pdf"),
            loss, te, tr, title=f"CIFAR LeNet {algo} ({len(loss)} steps)",
        )
    # the reference's committed finals, for the side-by-side block (REAL
    # CIFAR data there vs the synthetic stand-in here: compare shapes of
    # the comparison, not raw numbers)
    ref = {}
    for name, d in (("sp_hmc", "SP"), ("mp_hmc", "MP"), ("pmp_hmc", "PMP")):
        pats = glob.glob(f"{REF}/complex_nets/Cifar-10/{d}/*test_acc*.npy")
        losses = glob.glob(f"{REF}/complex_nets/Cifar-10/{d}/*loss*.npy")
        if pats and losses:
            a = np.load(pats[0])
            l = np.load(losses[0])  # noqa: E741
            ref[name] = {
                "steps": int(len(a)),
                "test_acc_last_1k_mean": float(a[-1000:].mean()),
                "loss_last_1k_mean": float(l[-1000:].mean()),
            }
    res["reference_committed"] = {
        "note": (
            "finals of the reference's committed 50k-step traces on real "
            "CIFAR-10 (different data than the synthetic stand-in — "
            "ordering comparisons only); empty without a checkout of the "
            "reference"
        ),
        **ref,
    }
    os.makedirs(out_dir, exist_ok=True)
    _cifar_compare_pdf(out_dir)
    recon = _cifar_reconciliation(res, abl_dir)
    if recon is not None:
        res["ordering_reconciliation"] = recon
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    return res


def _cifar_reconciliation(paper_res, abl_dir=f"{ROOT}/cifar_ablation"):
    """Reconcile the stand-in's test-acc ordering against the
    reference's committed MP>SP>PMP with the harder-data ablation: the
    same protocol at class_sep 0.15 + 15% label noise, 5000 steps, where
    nothing saturates within the budget.  None until the ablation's three
    traces exist."""
    abl = {}
    for algo in ("sp_hmc", "mp_hmc", "pmp_hmc"):
        base = os.path.join(abl_dir, f"cifar_{algo}")
        try:
            loss = np.load(base + ".loss.npy")
            tr = np.load(base + ".train_acc.npy")
            te = np.load(base + ".test_acc.npy")
        except FileNotFoundError:
            return None  # ablation incomplete; skip the block
        k = max(1, min(500, len(loss) // 10))
        abl[algo] = {
            "steps": int(len(loss)),
            "loss_last_mean": float(loss[-k:].mean()),
            "train_acc_last_mean": float(tr[-k:].mean()),
            "test_acc_last_mean": float(te[-k:].mean()),
        }
    order = sorted(abl, key=lambda a: -abl[a]["test_acc_last_mean"])
    # overfit gap on the PAPER protocol: train-fit minus test acc
    gaps = {
        a: round(
            paper_res[a]["train_acc_last_1k_mean"]
            - paper_res[a]["test_acc_last_1k_mean"],
            4,
        )
        for a in ("sp_hmc", "mp_hmc", "pmp_hmc")
        if isinstance(paper_res.get(a), dict) and "steps" in paper_res[a]
    }
    return {
        "question": (
            "how does the stand-in's 50k test-acc ordering relate to the "
            "reference's committed real-CIFAR MP > SP > PMP?"
        ),
        "mechanism": (
            "on the easy stand-in a fast-mixing sampler can drive "
            "train_acc to ~1.0 and memorize the 5% flipped labels, which "
            "costs test accuracy, while a slower one is effectively "
            "early-stopped; the overfit gaps below measure that.  On "
            "harder data (class_sep 0.15, 15% noise) where no sampler "
            "saturates within the budget, the ablation's ordering is the "
            "samplers' own"
        ),
        "paper_overfit_gap_train_minus_test": gaps,
        "ablation_protocol": (
            "class_sep 0.15 + 15% label noise, 5000 supersteps, same "
            "warm start / step sizes / bf16 as the paper cells "
            f"({abl_dir}/)"
        ),
        "ablation_finals": abl,
        "ablation_test_acc_ordering": " > ".join(
            o.split("_")[0].upper() for o in order
        ),
    }


def _cifar_compare_pdf(out_dir):
    """Side-by-side figure: the port's traces (solid) vs the reference's
    committed 50k-step traces (dashed) where a checkout of the reference
    is present.  The datasets differ (synthetic stand-in vs real
    CIFAR-10 — the figure says so), so the comparison is of curve SHAPE
    and sampler ordering, not raw accuracy."""
    plt = _plt()
    if plt is None:
        return
    cells = (
        ("sp_hmc", "SP", "mhhmc", "tab:blue"),
        ("mp_hmc", "MP", "mphmc", "tab:orange"),
        ("pmp_hmc", "PMP", "pmphmc", "tab:green"),
    )
    fig, (axl, axa) = plt.subplots(1, 2, figsize=(11, 4))
    drew = False
    for algo, rdir, rstem, color in cells:
        base = os.path.join(out_dir, f"cifar_{algo}")
        try:
            loss = np.load(base + ".loss.npy")
            te = np.load(base + ".test_acc.npy")
        except FileNotFoundError:
            continue
        axl.plot(loss, color=color, lw=0.6, label=f"pmpx_torch {algo}")
        axa.plot(te, color=color, lw=0.6)
        rl = f"{REF}/complex_nets/Cifar-10/{rdir}/cifar_{rstem}_loss.npy"
        ra = f"{REF}/complex_nets/Cifar-10/{rdir}/cifar_{rstem}_test_acc.npy"
        if os.path.exists(rl) and os.path.exists(ra):
            axl.plot(np.load(rl), color=color, lw=0.6, ls="--", alpha=0.6,
                     label=f"reference {algo}")
            axa.plot(np.load(ra), color=color, lw=0.6, ls="--", alpha=0.6)
        drew = True
    if not drew:
        plt.close(fig)
        return
    axl.set_yscale("log")
    axl.set_xlabel("superstep")
    axl.set_ylabel("loss (log)")
    axa.set_xlabel("superstep")
    axa.set_ylabel("test accuracy")
    fig.suptitle(
        "CIFAR LeNet HMC: pmpx_torch (synthetic stand-in, solid) vs "
        "reference committed traces (real CIFAR-10, dashed) — compare "
        "shape/ordering, not raw values"
    )
    fig.legend(loc="lower center", ncol=6, fontsize=8)
    fig.tight_layout(rect=(0, 0.06, 1, 1))
    fig.savefig(os.path.join(out_dir, "compare_vs_reference.pdf"))
    plt.close(fig)


def bnn(out_dir=f"{ROOT}/bnn_flagship"):
    from pmpx_torch.metrics.analysis import iteration_speedup

    res = {"protocol": (
        "Bayesian Network Training/main.py 30k-step protocol: "
        "torchbnn-style BayesLinear MLP 784-1024-10 (sampling forward), "
        "full-batch 60000, PMP-HMC N=3 (n=2) barker_clamp vs SP-HMC "
        "baseline (MNIST_bnn_NVIDIAA100.ipynb); steady_ms excludes the "
        "first chunk (the kernels' build and the chain's capture; median "
        "of the later chunks' walls)"
    )}
    arrays = {}
    for algo, stem in (("sp_hmc", "bnn_sphmc"), ("pmp_hmc", "bnn_pmphmc_N3")):
        base = os.path.join(out_dir, stem)
        try:
            loss = np.load(base + ".loss.npy")
            acc = np.load(base + ".acc.npy")
        except FileNotFoundError:
            res[algo] = {"note": "trace not present"}
            continue
        meta = _meta(base)
        arrays[algo] = loss
        res[algo] = {
            "steps": int(len(loss)),
            "loss_first": float(loss[0]),
            "loss_last_1k_mean": float(loss[-1000:].mean()),
            "acc_last_1k_mean": float(acc[-1000:].mean()),
            "steady_ms_per_superstep": meta.get(
                "steady_ms_per_superstep"
            ),
        }
    if "sp_hmc" in arrays and "pmp_hmc" in arrays:
        try:
            slope, cf, cb = iteration_speedup(
                arrays["pmp_hmc"], arrays["sp_hmc"]
            )
            res["speedup_fit_iterations"] = float(slope)
            res["pmp_crossings"] = [
                None if np.isnan(v) else int(v) for v in cf
            ]
            res["sp_crossings"] = [
                None if np.isnan(v) else int(v) for v in cb
            ]
        except Exception as e:
            res["speedup_fit_error"] = str(e)[:200]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "bnn_flagship.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    return res


# the reference protocol's step count of each MNIST model
MNIST_FULL = {"FC": 500000, "CNN": 250000, "LSTM": 1000000}


def mnist(out_dir=f"{ROOT}/mnist", kernel_dir=f"{ROOT}/mnist_kernel"):
    res = {"protocol": (
        "reference Mnist/{FC,CNN,LSTM} protocol: full-batch 60000, "
        "alpha=1e-4, N=7, z-score, single-draw selection; tempering is "
        "per-algo like the reference's (MH effective -1000*CE from "
        "MH_FC.py lamb=10000 on CE/10; MP/PMP -10*CE); synthetic MNIST at "
        "class_sep=0.35 + 5% label noise (accuracy ceiling ~0.955, loss "
        "floor > 0); step counts are honest per trace name (FC 500k, CNN "
        "250k, LSTM 1M = the full protocol; each entry states its "
        "fraction); the LSTM runs through the lstm_fused kernel "
        "(--lstm-kernel true, '@kernel' cells)"
    )}
    # kernel-path runs (pmpx_torch.kernels.lstm_fused, --lstm-kernel) live
    # in their own dir: same stem grammar, another density-rounding
    # protocol — never merged with the generic-path chains, summarized as
    # separate "<stem>@kernel" cells
    scan = [(out_dir, "")]
    if kernel_dir and os.path.isdir(kernel_dir):
        scan.append((kernel_dir, "@kernel"))
    for d, tag in scan:
        for path in sorted(glob.glob(os.path.join(d, "*.json"))):
            stem = os.path.basename(path)[:-5]
            if stem == "summary" or stem.endswith(".protocol"):
                continue
            loss_p = os.path.join(d, stem + ".loss.npy")
            if not os.path.exists(loss_p):
                continue
            loss = np.load(loss_p)
            with open(path) as f:
                meta = json.load(f)
            full = MNIST_FULL.get(meta.get("model", ""), None)
            k = max(1, min(10000, len(loss) // 10))
            res[stem + tag] = {
                "model": meta.get("model"),
                "steps": int(len(loss)),
                "fraction_of_reference_protocol": (
                    round(len(loss) / full, 3) if full else None
                ),
                "loss_first": float(loss[0]),
                "loss_mean_last_chunk": float(loss[-k:].mean()),
                "train_acc": meta.get("train_acc"),
                "test_acc": meta.get("test_acc"),
                "steady_ms_per_superstep": meta.get(
                    "steady_ms_per_superstep"
                ),
                **({"path": "fused_kernel"} if tag else {}),
            }

    # a queue extends a chain through resumable rungs, so several stems
    # can be honest prefixes of the same run; point the reader at the
    # longest per (algo, model, path) cell and mark the rest superseded
    def _cell(stem, row):
        tag = "_kernel" if "@kernel" in stem else ""
        return f"{stem.split('_')[0]}_{row.get('model')}{tag}"

    best = {}
    for stem, row in res.items():
        if not isinstance(row, dict) or "steps" not in row:
            continue
        cell = _cell(stem, row)
        if cell not in best or row["steps"] > res[best[cell]]["steps"]:
            best[cell] = stem
    for stem, row in res.items():
        if isinstance(row, dict) and "steps" in row:
            top = best[_cell(stem, row)]
            if top != stem:
                row["superseded_by"] = top
    # a generic-path cell whose protocol continues on the kernel path is
    # frozen as recorded: the kernel path is the same sampler under
    # another density-rounding protocol (chains never splice)
    for cell, stem in best.items():
        if cell + "_kernel" in best:
            res[stem]["final"] = True
            res[stem]["frozen_note"] = (
                "generic-path cell frozen at this honest prefix; the "
                "reference protocol continues on the kernel path "
                f"(another density-rounding protocol, see the "
                f"{cell}_kernel cell) — kernel and generic chains are "
                "never spliced"
            )
    res["current_cells"] = dict(sorted(best.items()))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(res, f, indent=1)
    _mnist_curves_pdf(out_dir, kernel_dir=kernel_dir)
    print(json.dumps(res, indent=1))
    return res


def _mnist_curves_pdf(out_dir, kernel_dir=f"{ROOT}/mnist_kernel"):
    """One panel per model (FC/CNN/LSTM), every algo's loss trace at its
    honest length; kernel-path chains (``--lstm-kernel``) dashed as
    ``@kernel``."""
    plt = _plt()
    if plt is None:
        return
    best = {}  # (model, algo) -> longest loss trace
    scan = [(out_dir, "")]
    if kernel_dir and os.path.isdir(kernel_dir):
        scan.append((kernel_dir, "@kernel"))
    for d, tag in scan:
        for path in sorted(glob.glob(os.path.join(d, "*.loss.npy"))):
            stem = os.path.basename(path)[: -len(".loss.npy")]
            algo = stem.split("_")[0] + tag
            for m in ("FC", "CNN", "LSTM"):
                if stem.endswith(f"{m}_N_7") or f"{m}_N_" in stem:
                    loss = np.load(path)
                    if len(loss) > len(best.get((m, algo), ())):
                        best[(m, algo)] = loss
                    break
    by_model = {}
    for (m, algo), loss in best.items():
        by_model.setdefault(m, []).append((algo, loss))
    if not by_model:
        return
    models = [m for m in ("FC", "CNN", "LSTM") if m in by_model]
    fig, axes = plt.subplots(1, len(models), figsize=(5 * len(models), 4))
    if len(models) == 1:
        axes = [axes]
    colors = {"MH": "tab:blue", "MP": "tab:orange", "PMP": "tab:green",
              "PMP@kernel": "tab:red", "MH@kernel": "tab:purple",
              "MP@kernel": "tab:brown"}
    for ax, m in zip(axes, models):
        for algo, loss in sorted(by_model[m], key=lambda t: t[0]):
            ax.plot(loss, lw=0.5, color=colors.get(algo, "gray"),
                    ls="--" if algo.endswith("@kernel") else "-",
                    label=f"{algo} ({len(loss)} steps)", alpha=0.85)
        ax.set_yscale("log")
        ax.set_xlabel("superstep")
        ax.set_title(m)
        ax.legend(fontsize=7)
    axes[0].set_ylabel("tempered CE loss (log)")
    fig.suptitle(
        "MNIST paper-protocol cells, de-saturated synthetic stand-in "
        "(honest step counts per legend)"
    )
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "curves.pdf"))
    plt.close(fig)


def ess(scan_dir=f"{ROOT}/ess_scan", fused_dir=f"{ROOT}/ess_fused",
        out_dir=f"{ROOT}/ess_paths"):
    """Superstep-path vs fused-kernel overlay of the reference's ESS/MSJD
    P sweep.

    Both input summaries (``ess_msjd``'s ``summary.json``) carry the P
    grid per algo family on the all-stream estimator (the reference's
    emit-every-proposal protocol, ``ess_per_s_MP.cu:265-278``).  The JSON
    records the fused/superstep ratio per cell.  Returns None, with a
    note, when either summary is missing.
    """
    paths = {}
    for name, d in (("scan", scan_dir), ("fused", fused_dir)):
        p = os.path.join(d, "summary.json")
        if not os.path.exists(p):
            print(f"ess: {p} missing; skipped")
            return None
        with open(p) as f:
            paths[name] = json.load(f)

    # rows[metric][(algo, path)] = [(P, v), ...]
    rows = {"ess_per_s": {}, "msjd_per_s": {}}
    for path_name, data in paths.items():
        for k, v in data.items():
            parts = k.split("_", 2)
            if len(parts) != 3 or not parts[2].startswith("all_"):
                continue  # all-stream estimator only (the protocol's)
            algo, P, metric = parts[0], int(parts[1][1:]), parts[2][4:]
            if metric in rows:
                rows[metric].setdefault((algo, path_name), []).append(
                    (P, float(v))
                )

    ratios = {}
    for metric, series in rows.items():
        for (algo, _), pts in series.items():
            scan = dict(series.get((algo, "scan"), []))
            fused = dict(series.get((algo, "fused"), []))
            for P in sorted(set(scan) & set(fused)):
                ratios.setdefault(metric, {})[f"{algo}_P{P}"] = round(
                    fused[P] / scan[P], 3
                )
    res = {
        "protocol": (
            "all-stream (emit-every-proposal) estimator, 1M-step "
            "protocol, P grid per data_trans.py:8; ratio = fused chain "
            "kernel / superstep path on the CUDA card; >1 means the "
            "fused kernel gives more ESS (MSJD) a second at that P"
        ),
        "fused_over_scan": ratios,
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ess_paths.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))

    plt = _plt()
    if plt is None:
        return res
    colors = {"mp": "tab:orange", "pmp": "tab:green"}
    for metric, fname in (("ess_per_s", "ess_paths_compare.pdf"),
                          ("msjd_per_s", "msjd_paths_compare.pdf")):
        fig = plt.figure(figsize=(6, 4))
        for (algo, path_name), pts in sorted(rows[metric].items()):
            pts = sorted(pts)
            plt.plot([p for p, _ in pts], [v for _, v in pts],
                     marker="o" if path_name == "fused" else "s",
                     ls="-" if path_name == "fused" else "--",
                     color=colors.get(algo, "gray"),
                     label=f"{algo.upper()} {path_name}")
        plt.xscale("log", base=2)
        plt.yscale("log")
        plt.xlabel("parallelism P")
        plt.ylabel("all-stream " + metric.replace("_", "/"))
        plt.title("1M-step protocol: fused kernel vs superstep path")
        plt.legend(fontsize=8)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, fname))
        plt.close(fig)
    return res


def main(which: str = "all", root: str = ROOT) -> dict:
    """Summarizes ``which`` family (or ``all``) of the traces under
    ``root``; returns each family's summary (None where skipped)."""
    out = {}
    if which in ("cifar", "all"):
        out["cifar"] = cifar(f"{root}/cifar", f"{root}/cifar_ablation")
    if which in ("bnn", "all"):
        out["bnn"] = bnn(f"{root}/bnn_flagship")
        out["bnn_hard"] = bnn(f"{root}/bnn_hard")
    if which in ("mnist", "all"):
        out["mnist"] = mnist(f"{root}/mnist", f"{root}/mnist_kernel")
    if which in ("ess", "all"):
        out["ess"] = ess(f"{root}/ess_scan", f"{root}/ess_fused",
                         f"{root}/ess_paths")
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "all",
         sys.argv[2] if len(sys.argv) > 2 else ROOT)
