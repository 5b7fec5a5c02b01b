"""Drive the NN-posterior zoo on the CUDA card (the port of
``scripts/run_zoo.py``).

MNIST: {FC, CNN, LSTM} x {MH, MP, PMP} (reference
``complex_nets/Mnist/*/{MH,MP,PMP}_*.py`` — 9 scripts, 9 cells here) and
CIFAR: LeNet x {SP, MP, PMP}-HMC (``cifar_{SP,MP,PMP}hmc.py``).
Data difficulty (class_sep) is set so accuracy curves separate *below*
ceiling, making the sampler comparison meaningful.

Usage: python scripts/run_zoo_torch.py [out_root] [--device cpu]

``out_root`` defaults to ``results/zoo``; each family writes its
``summary.json`` under ``<out_root>/{mnist,cifar}_zoo/``.  ``main`` takes
the table of cells (``CELLS``): a table without CIFAR cells skips them.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# (family, the experiment's run() arguments) of every cell, at the sizes
# of run_zoo.py: a weak warm start (like the reference's half-trained
# pkls) and hard class separation, so that the SAMPLER does the
# optimization and per-iteration convergence discriminates the samplers
CELLS = tuple(
    ("mnist", dict(model=model, algo=algo, num_steps=2000, n_train=4096,
                   n_test=1024, pretrain_steps=15, class_sep=0.35))
    for model in ("FC", "CNN", "LSTM") for algo in ("mh", "mp", "pmp")
) + tuple(
    ("cifar", dict(algo=algo, num_steps=60, n_train=2048, n_test=512,
                   pretrain_steps=30, class_sep=0.45))
    for algo in ("sp_hmc", "mp_hmc", "pmp_hmc")
)

CIFAR_NOTE = (
    "smoke-scale zoo run (tens of supersteps from a warm start) "
    "— a cheap regression cell only; do NOT read sampler "
    "orderings from it.  Paper-scale results: "
    "results/paper/cifar/ (the 50,000-superstep protocol of "
    "scripts/paper_queue_torch.json)."
)


def main(cells=CELLS, out_root: str = "results/zoo", device=None) -> dict:
    """Runs ``cells`` in order and writes each family's summary; returns
    ``{"mnist": rows, "cifar": rows}`` (a family without cells is
    absent)."""
    from pmpx_torch._device import resolve_device
    from pmpx_torch.experiments import cifar_hmc, mnist

    dev = resolve_device(device)
    rows = {}
    for family, kw in cells:
        out_dir = os.path.join(out_root, f"{family}_zoo")
        t0 = time.time()
        if family == "mnist":
            out = mnist.run(out_dir=out_dir, device=dev, **kw)
            out.update(model=kw["model"], algo=kw["algo"])
        else:
            out = cifar_hmc.run(out_dir=out_dir, device=dev, **kw)
            out.update(algo=kw["algo"])
        out.update(wall_s=time.time() - t0)
        rows.setdefault(family, []).append(out)
        print(json.dumps(out), flush=True)
    for family, got in rows.items():
        summary = got if family == "mnist" else {"note": CIFAR_NOTE,
                                                 "cells": got}
        with open(os.path.join(out_root, f"{family}_zoo",
                               "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_root", nargs="?", default="results/zoo")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    main(out_root=args.out_root, device=args.device)
