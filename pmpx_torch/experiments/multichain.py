"""Multi-chain convergence diagnostics: R-hat, per-chain ESS, pooled moments
(port of ``pmpx/experiments/multichain.py``).

Beyond the reference (which runs independent chains only as hand-pinned
processes with no cross-chain diagnostics, SURVEY.md §2.5): C chains run
as one batch (:func:`pmpx_torch.parallel.run_chains_vmapped`) or over the
``chains`` axis of a mesh of ranks (:func:`pmpx_torch.parallel.
run_chains_sharded`, each rank a block of chains as one batch), and
split-R-hat / per-chain ESS quantify convergence.  ``sharded=True`` runs
the chains over ``make_mesh(chains=n_chains)``; :func:`sweep`'s
``path="sharded"`` and ``path="fused"`` (the fused chain farm, one kernel
launch of a rank's chains a chunk) over a chains axis as wide as the
largest divisor of ``n_chains`` that the world holds (one rank in a
process with no world).  The overdispersed starting states come from
``numpy.random.default_rng(seed)``, as in ``pmpx``, so both packages start
from the same states.  In a world of several ranks, global rank 0 writes
the files and every rank of the mesh returns the summary; a rank outside
the mesh returns ``None``.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from pmpx_torch._device import resolve_device
from pmpx_torch.config import SamplerSpec
from pmpx_torch.experiments._common import device_name, seeded, sync
from pmpx_torch.kernels import fused_chain as fc
from pmpx_torch.metrics import ess, ess_chunked, split_rhat
from pmpx_torch.metrics.recorder import save_trace
from pmpx_torch.parallel import (
    chain_generators, make_chain_farm_fused, make_mesh, run_chains_sharded,
    run_chains_vmapped,
)
from pmpx_torch.targets.linreg import BayesLinReg, make_synthetic_linreg

_NAMES = ("beta0", "beta1", "sigma")


def chain_target(n_data: int, seed: int = 0, method: str = "auto",
                 device=None) -> BayesLinReg:
    """The experiment's target: synthetic data of ``n_data`` points drawn
    from ``seed`` on ``device``, tempered by 50/n (``lb.py:35``)."""
    dev = resolve_device(device)
    x, y = make_synthetic_linreg(seeded(seed, dev), n_data)
    return BayesLinReg(x, y, temper=50.0 / n_data, method=method,
                       device=dev)


def _writes() -> bool:
    """Whether this process writes the files: global rank 0, or a process
    with no world."""
    return not dist.is_initialized() or dist.get_rank() == 0


def overdispersed(seed: int, n_chains: int, device=None) -> torch.Tensor:
    """(C, 3) starting states, overdispersed in EVERY coordinate (sigma
    included), as R-hat methodology requires: ``pmpx``'s draws."""
    rng = np.random.default_rng(seed)
    inits = rng.uniform(-3, 3, size=(n_chains, 2))
    sigmas = rng.uniform(0.3, 2.0, size=(n_chains, 1))
    return torch.tensor(np.concatenate([inits, sigmas], axis=1),
                        dtype=torch.float32, device=resolve_device(device))


def run(
    n_data: int = 4096,
    n_chains: int = 8,
    num_steps: int = 800,
    algo: str = "pmp",
    N: int = 1,
    depth: int = 3,
    step_size: float = 0.05,
    sharded: bool = False,
    seed: int = 0,
    out_dir: str = "results/multichain",
    scale: str = "smoke",
    method: str = "auto",
    mode: str = "single",
    ps: str = "8,16,32,64,128,256,512",
    algos: str = "mp,pmp",
    path: str = "sharded",
    chunk: int = 500,
    out_name: str = "",
    device=None,
):
    """``mode="single"``: C chains of one sampler, with split-R-hat, mean
    per-chain ESS and pooled means of the tail half.  ``mode="sweep"``:
    :func:`sweep`'s table over ``ps`` x ``algos`` on ``path``.
    ``sharded=True`` runs the chains over ``make_mesh(chains=n_chains)``
    (its ValueError where the world has fewer ranks), one chain a rank,
    each from a generator seeded from (seed + 1, its chains coordinate)."""
    dev = resolve_device(device)
    if mode == "sweep":
        # chain-farm ESS/R-hat table (``--mode sweep``); comma-separated
        # --ps / --algos, e.g. the paper-grade 1M-step fused farm:
        #   multichain --mode sweep --path fused --num-steps 1000000
        # the CLI pre-parses "8,16" into a tuple; accept both forms
        if isinstance(ps, str):
            ps = tuple(int(p) for p in ps.split(",") if p)
        elif isinstance(ps, int):
            ps = (ps,)
        if isinstance(algos, str):
            algos = tuple(a for a in algos.split(",") if a)
        return sweep(
            Ps=tuple(ps), algos=tuple(algos),
            n_chains=n_chains, num_steps=num_steps, n_data=n_data,
            step_size=step_size, seed=seed, out_dir=out_dir, path=path,
            chunk=chunk, out_name=out_name or None, device=dev,
        )
    if scale == "paper":
        n_data, num_steps = 100000, 5000
    target = chain_target(n_data, seed, method, dev)
    spec = SamplerSpec(
        algo=algo, N=N, depth=depth, step_size=step_size,
        selection="all_first",
    )
    superstep = spec.build(target)
    theta0 = overdispersed(seed, n_chains, dev)
    collect = lambda th, o: th  # noqa: E731
    if sharded:
        mesh = make_mesh(chains=n_chains, devices=dev)
        if mesh is None:
            return None
        _, roots = run_chains_sharded(superstep, seed + 1, theta0,
                                      num_steps, mesh, collect, device=dev)
    else:
        _, roots = run_chains_vmapped(superstep, seeded(seed + 1, dev),
                                      theta0, num_steps, collect=collect)
    half = num_steps // 2
    tail = roots[:, half:, :]

    out = {}
    for j, name in enumerate(_NAMES):
        vals = tail[:, :, j].abs() if name == "sigma" else tail[:, :, j]
        out[f"rhat_{name}"] = float(split_rhat(vals))
        out[f"ess_{name}"] = float(np.mean([float(ess(v)) for v in vals]))
        out[f"mean_{name}"] = float(vals.double().mean())
    if _writes():
        save_trace(out_dir, "multichain", {"roots": roots.cpu().numpy()},
                   out)
    return out


def sweep(
    Ps=(8, 16, 32, 64, 128, 256, 512),
    algos=("mp", "pmp"),
    n_chains: int = 8,
    num_steps: int = 5000,
    n_data: int = 100000,
    step_size: float = 0.05,
    seed: int = 0,
    out_dir: str = "results/multichain",
    path: str = "sharded",
    chunk: int = 500,
    out_name: str | None = None,
    device=None,
):
    """Chain-farm ESS table: aggregate ESS/s + split-R-hat per P.

    For each (algo, P) cell: P proposals per superstep — flat MTM with N =
    P (P + 1 states) for ``mp`` (reference ``ess_per_s_MP.cu``), a binary
    depth-log2(P) tree for ``pmp`` (``ess_per_s_PMP.cu``).  ``path=
    "fused"`` farms the fused chain kernel (sufficient-statistics
    likelihood, ``chunk`` supersteps a launch, a rank's chains in each
    launch); ``"sharded"`` runs the chain-batched superstep of
    :func:`run_chains_sharded`.  Both run over a chains axis as wide as
    ``pmpx``'s cap: the largest divisor of ``n_chains`` no larger than the
    world (a rank past it returns ``None``).  Each cell's runner is built
    once; a warm-up call of the same length comes
    before the timed call, each clock read after a device sync.  Wall time
    is the timed call's; aggregate ESS/s sums the per-chain tail ESS of
    every coordinate stream across chains, and split-R-hat certifies that
    the farm converged.
    """
    if path not in ("fused", "sharded"):
        raise ValueError(f"path is 'fused' or 'sharded', got {path!r}")
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    cap = max(s for s in range(1, min(n_chains, world) + 1)
              if n_chains % s == 0)
    mesh = make_mesh(chains=cap, devices=dev)
    if mesh is None:
        return None
    target = chain_target(n_data, seed, device=dev)
    theta0 = overdispersed(seed, n_chains, dev)
    collect = lambda th, o: th  # noqa: E731
    rows = []
    for algo in algos:
        for P in Ps:
            if algo == "pmp":
                depth = int(np.log2(P))
                if (1 << depth) != P:
                    raise ValueError(f"binary PMP needs P a power of 2, "
                                     f"got {P}")
                spec = SamplerSpec(
                    algo="pmp", N=1, depth=depth, step_size=step_size,
                    selection="all_first",
                )
            else:
                spec = SamplerSpec(
                    algo="mp", N=P, depth=1, step_size=step_size,
                    selection="all_first",
                )
            if path == "fused":
                run_farm = make_chain_farm_fused(
                    target, fc.spec_to_cfg(spec), num_steps, mesh,
                    chunk=min(chunk, num_steps),
                )

                def farm(s, f=run_farm):
                    return f(chain_generators(s, n_chains, dev), theta0)
            else:
                superstep = spec.build(target)

                def farm(s, sup=superstep):
                    return run_chains_sharded(sup, s, theta0, num_steps,
                                              mesh, collect, device=dev)[1]
            farm(seed + 1)  # warm-up
            sync(dev)
            t0 = time.perf_counter()
            roots = farm(seed + 2)
            sync(dev)
            wall = time.perf_counter() - t0
            tail = roots[:, num_steps // 2:, :]  # (chains, steps, 3)
            row = {
                "algo": algo,
                "P": int(P),
                "chains": int(n_chains),
                "steps": int(num_steps),
                "wall_s": float(wall),
            }
            # long streams (the 1M-step paper farm): the host's chunked
            # Geyer estimator in float64, O(block) memory
            long_stream = tail.shape[1] >= (1 << 18)
            total_ess = 0.0
            for j, name in enumerate(_NAMES):
                vals = tail[:, :, j].abs() if j == 2 else tail[:, :, j]
                row[f"rhat_{name}"] = float(split_rhat(vals))
                if long_stream:
                    ch_ess = [ess_chunked(v) for v in vals.cpu().numpy()]
                else:
                    ch_ess = [float(ess(v)) for v in vals]
                total_ess += sum(ch_ess)
                row[f"ess_{name}"] = float(np.sum(ch_ess))
            row["agg_ess_per_s"] = total_ess / wall
            rows.append(row)
            if _writes():
                print(
                    f"[multichain.sweep] {algo} P={P}: "
                    f"agg_ess_per_s={row['agg_ess_per_s']:.1f} "
                    f"rhat_beta1={row['rhat_beta1']:.4f} wall={wall:.2f}s",
                    flush=True,
                )
    how = ("the fused chain farm, one launch of a rank's chains a chunk"
           if path == "fused" else "chain-batched")
    where = ("on one card" if cap == 1
             else f"over {cap} ranks of the chains axis")
    summary = {
        "protocol": (
            f"{n_chains} chains {where} ({device_name(dev)}), {how}, "
            f"synthetic linreg n={n_data}, {num_steps} supersteps, "
            "tail-half metrics"
        ),
        "path": path,
        "rows": rows,
    }
    name = out_name or (
        "chain_farm_fused.json" if path == "fused" else "chain_farm.json"
    )
    if _writes():
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(summary, f, indent=1)
    return summary
