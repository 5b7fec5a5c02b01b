"""(dimension, depth, chain-length) correlation sweep -> CSV (port of
``pmpx/experiments/correlation.py``).

Parity with ``complex_nets/correlation/com_dim.py``: binary-tree PMP on a
d-dimensional standard MVN started at 2.5*ones, proposal sigma 0.5, sweep
dims x N in {1,3,7,15,31} (depth = log2(N+1) in 1..5) x chain lengths,
recording mean +- std of the pooled samples -> ``dimension_Chins_Parl.csv``
(the README.md:66-96 table).  Note: the reference's ``10**(d/10)``
transition scale (``com_dim.py:18-21``) is a linear-space overflow device
that cancels in every normalized weight ratio, so log-space computation
needs no analog.  Each (dim, N) cell is one chain.
"""

from __future__ import annotations

import csv
import os

import torch

from pmpx_torch import tree
from pmpx_torch._device import resolve_device
from pmpx_torch.config import SamplerSpec
from pmpx_torch.experiments._common import as_tuple, seeded
from pmpx_torch.samplers.base import run_chain
from pmpx_torch.targets import StandardMVN


def run(
    dims=(10, 20, 40, 80, 160),
    Ns=(1, 3, 7, 15, 31),
    nums=(50, 100, 150, 200, 250),
    hops: int = 500,
    sigma: float = 0.5,
    seed: int = 0,
    out_dir: str = "results/correlation",
    scale: str = "smoke",
    device=None,
):
    dev = resolve_device(device)
    dims, Ns, nums = as_tuple(dims), as_tuple(Ns), as_tuple(nums)
    if scale == "smoke":
        dims = dims[:3]
        Ns = Ns[:3]
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    out = {}
    for dim in dims:
        target = StandardMVN(d=dim)
        theta0 = torch.full((dim,), 2.5, device=dev)
        for N in Ns:
            depth = tree.binary_depth(N + 1)
            spec = SamplerSpec(
                algo="pmp", N=1, depth=max(depth, 1),
                step_size=sigma, trans_sigma=sigma,
            )
            superstep = spec.build(target)
            _, recs = run_chain(superstep, seeded(seed, dev), theta0, hops)
            s = recs["samples"].reshape(-1, dim).cpu().numpy()
            for num in nums:
                chunk = s[: num * (N + 1)]
                rows.append(
                    (dim, depth, num, float(chunk.mean()), float(chunk.std()))
                )
    csv_path = os.path.join(out_dir, "dimension_chains_parallel.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["dim", "depth", "chain_len", "mean", "std"])
        w.writerows(rows)
    # summary: error at the largest chain length for the deepest tree
    for dim, depth, num, m, s_ in rows:
        if num == max(nums):
            out[f"d{dim}_D{depth}_mean"] = m
            out[f"d{dim}_D{depth}_std"] = s_
    out["csv"] = csv_path
    return out
