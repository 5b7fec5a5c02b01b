"""ESS/s and MSJD/s vs. parallelism P (port of
``pmpx/experiments/ess_msjd.py``).

Parity with ``simple_net/MP_and_PMP_ESS_per_sec_and_MSJD_per_sec/``: the
reference dumps million-step MP/PMP sample streams per P in {8..512}
(``data_trans.py:8``) and computes ESS/MSJD offline with code not in its
repository.  Here the run, its timing and the estimators (Geyer ESS, MSJD
per second) run in one pipeline, and the summary is the table behind
``ess_compare.pdf`` / ``msjd_compare.pdf``.  The fused cells run the CUDA
chain kernel: ``emit="all"`` for the per-slot protocol, the chain farm for
``chains > 1``.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from pmpx_torch import tree
from pmpx_torch._device import resolve_device
from pmpx_torch.config import SamplerSpec
from pmpx_torch.experiments._common import as_tuple, seeded, sync
from pmpx_torch.experiments.plots import render_ess_msjd
from pmpx_torch.metrics import ess, ess_chunked, ess_per_dim, msjd
from pmpx_torch.metrics.recorder import save_trace
from pmpx_torch.samplers.base import compile_chain
from pmpx_torch.targets.linreg import BayesLinReg, make_synthetic_linreg

def ess_target(n_data: int, seed: int = 0, method: str = "fused",
               device=None) -> BayesLinReg:
    """The experiment's target: synthetic data of ``n_data`` points drawn
    from ``seed`` on ``device``, tempered by 1/2000 as the reference's
    ESS protocol tempers it."""
    dev = resolve_device(device)
    x, y = make_synthetic_linreg(seeded(seed, dev), n_data)
    return BayesLinReg(x, y, temper=1.0 / 2000.0, method=method, device=dev)


def _emit_all_cell(
    target, spec, theta0, num_steps, burn_in, emit_chunk, out_dir,
    seed, keep_emit, tag,
):
    """One emit-all protocol cell on the superstep path: returns
    (root_ess, root_msjd_sum, all_ess, all_msjd_sum, wall_s)."""
    dev = theta0.device
    # one compiled chain for every chunk
    chain = compile_chain(spec.build(target), seeded(seed, dev), theta0,
                          lambda th, o: o["samples"])

    # Only the (n, P) beta0 columns cross to the host; the MSJD over the
    # flattened emitted stream (all coordinates) is reduced on the device
    # per chunk: the squared jumps inside the chunk, and the chunk's first
    # and last emitted states for the jumps across chunks.
    def runner(gen, t, start, n):
        theta2, samples_all = chain.run(gen, t, n)
        flat = samples_all.reshape(-1, samples_all.shape[-1])
        d = flat[1:] - flat[:-1]
        # keep only post-burn-in jumps: stream element i jumps to i + 1,
        # kept iff its global flattened index >= burn_in * P, so the MSJD
        # numerator matches the burn_in-trimmed windows of the ESS
        P_ = flat.shape[0] // n
        gidx = torch.arange(flat.shape[0] - 1, device=dev) + start * P_
        keep = gidx >= burn_in * P_
        sq = torch.sum(torch.where(keep[:, None], d * d, 0.0))
        return (theta2, samples_all[:, :, 0], samples_all[:, 0, :], sq,
                flat[0], flat[-1])

    os.makedirs(out_dir, exist_ok=True)
    colpath = os.path.join(out_dir, f"emit_{tag}.npy")
    P = (spec.N + 1) ** spec.depth if spec.algo == "pmp" else spec.N + 1
    cols = np.lib.format.open_memmap(
        colpath, mode="w+", dtype=np.float32, shape=(P, num_steps)
    )
    roots = np.empty((num_steps, 3), np.float32)
    # a warm-up outside the timed window, like the root cells' (its
    # results are discarded; the timed loop restarts from theta0 with a
    # generator seeded alike)
    runner(seeded(seed, dev), theta0, 0, min(emit_chunk, num_steps))
    sync(dev)
    gen = seeded(seed, dev)
    theta = theta0
    sq_sum, last = 0.0, None
    t0 = time.perf_counter()
    for s in range(0, num_steps, emit_chunk):
        n = min(emit_chunk, num_steps - s)
        theta, cols_c, roots_c, sq, first, lastc = runner(gen, theta, s, n)
        cols[:, s:s + n] = cols_c.T.cpu().numpy()
        roots[s:s + n] = roots_c.cpu().numpy()
        sq_sum += float(sq)
        if last is not None and s > burn_in:
            # the jump from the last of the previous chunk to the first
            # of this one; its earlier element has global index s*P - 1,
            # post-burn-in iff s > burn_in
            d = first.double().cpu().numpy() - last
            sq_sum += float((d * d).sum())
        last = lastc.double().cpu().numpy()
    dt = time.perf_counter() - t0
    return _finish_emit_cell(
        roots, cols, colpath, sq_sum, burn_in, num_steps, dt, keep_emit,
        dev,
    )


def _finish_emit_cell(
    roots, cols, colpath, sq_sum, burn_in, num_steps, dt, keep_emit,
    device=None,
):
    """Shared estimator tail of both emit-all paths: root ESS/MSJD,
    per-draw-slot stream ESS sum, flattened-stream MSJD numerator.  The
    FFT estimators run on ``device`` (CUDA unless given)."""
    dev = resolve_device(device)
    P = cols.shape[0]
    n_tail = num_steps - burn_in
    # past ~256k steps the 2n-padded FFT transient dominates the analysis
    # stage; the chunked host estimator is numerically the same (Geyer
    # truncation inside its adaptive window) at O(block) memory
    long_stream = n_tail >= (1 << 18)
    if long_stream:
        root_e = ess_chunked(roots[burn_in:, 0])
    else:
        root_e = float(ess(torch.tensor(roots[burn_in:, 0], device=dev)))
    root_m = float(msjd(torch.tensor(roots[burn_in:], device=dev))) * (
        num_steps - burn_in
    )
    # per-draw-slot stream ESS (the reference's dump streams as chains),
    # in batches so that the FFTs stay within device memory
    all_e = 0.0
    if long_stream:
        for j in range(P):
            all_e += ess_chunked(cols[j, burn_in:])
    else:
        B = 16
        for j in range(0, P, B):
            blk = np.ascontiguousarray(cols[j:j + B, burn_in:].T)
            all_e += float(torch.sum(ess_per_dim(
                torch.tensor(blk, device=dev))))  # (n, <= B) columns
    all_m = sq_sum  # MSJD-rate numerator over the flattened stream
    del cols
    if not keep_emit:
        os.remove(colpath)
    return root_e, root_m, all_e, all_m, dt


def _emit_all_cell_fused(
    target, spec, theta0, num_steps, burn_in, emit_chunk, out_dir,
    seed, keep_emit, tag,
):
    """The emit-all protocol cell on the fused chain kernel: the per-slot
    draws, the root path, the within-step squared-jump sums and each
    step's last-slot state all come out of the kernel
    (``fused_chain.make_fused_chain(emit="all")``); the host stitches the
    step and chunk boundary jumps ``||last[t] - root[t+1]||^2`` and runs
    the same estimator tail as the superstep cell."""
    from pmpx_torch.kernels import fused_chain as fc

    dev = theta0.device
    cfg = fc.spec_to_cfg(spec)
    P = (cfg.N + 1) ** cfg.depth
    kchunk = 500
    # emit_chunk a multiple of the kernel chunk, as pmpx keeps it
    emit_chunk = max(kchunk, (emit_chunk // kchunk) * kchunk)
    runk = fc.make_fused_chain(target, cfg, chunk=kchunk, emit="all")

    os.makedirs(out_dir, exist_ok=True)
    colpath = os.path.join(out_dir, f"emit_{tag}.npy")
    cols = np.lib.format.open_memmap(
        colpath, mode="w+", dtype=np.float32, shape=(P, num_steps)
    )
    roots = np.empty((num_steps, 3), np.float32)
    jumps = np.empty(num_steps, np.float64)
    lasts = np.empty((num_steps, 3), np.float32)
    # a warm-up outside the timed window (the kernel's build), results
    # discarded
    runk(seeded(seed, dev), theta0, min(emit_chunk, num_steps))
    sync(dev)
    gen = seeded(seed, dev)
    theta = theta0
    t0 = time.perf_counter()
    for s in range(0, num_steps, emit_chunk):
        n = min(emit_chunk, num_steps - s)
        out = runk(gen, theta, n)
        cols[:, s:s + n] = out["emit_b0"].cpu().numpy()
        roots[s:s + n] = out["root"].cpu().numpy()
        jumps[s:s + n] = out["jumps"].double().cpu().numpy()
        lasts[s:s + n] = out["last"].cpu().numpy()
        theta = out["root"][-1]
    dt = time.perf_counter() - t0

    # flattened-stream MSJD numerator: the kernel's within-step sums plus
    # every boundary jump last[t] -> root[t+1] (the next step's slot-0
    # draw is the next root under all_first); a jump is kept iff its
    # earlier element is post-burn-in, i.e. t >= burn_in, the superstep
    # cell's gidx >= burn_in*P rule at step granularity
    d = lasts[:-1].astype(np.float64) - roots[1:].astype(np.float64)
    sq_sum = float(jumps[burn_in:].sum()) + float((d[burn_in:] ** 2).sum())
    return _finish_emit_cell(
        roots, cols, colpath, sq_sum, burn_in, num_steps, dt, keep_emit,
        dev,
    )


def run(
    n_data: int = 10000,
    Ps=(8, 32, 128, 512),
    num_steps: int = 2000,
    burn_in: int = 200,
    algos=("mp", "pmp"),
    seed: int = 0,
    out_dir: str = "results/ess",
    scale: str = "smoke",
    method: str = "auto",
    chains: int = 1,
    trace: str = "root",
    emit_chunk: int = 20000,
    keep_emit: bool = False,
    device=None,
):
    """ESS/s and MSJD/s per algorithm and P; the summary keys are
    ``pmpx``'s.

    ``method``: ``fused_chain`` runs the fused chain kernel; any linreg
    method (``auto``, ``sweep``, ``fused``, ``suffstats``, and ``pmpx``'s
    ``pallas`` and ``xla``, the names of its sweeps) runs the superstep
    path over that method.

    ``chains > 1`` (fused path only): that many independent chains in one
    launch of the chain farm (one block each), and *aggregate* ESS/s and
    MSJD/s summed across chains.  The reference's counterpart is
    hand-pinning independent processes to GPUs.

    ``trace`` selects the estimator protocol:

    * ``"root"``: ESS/MSJD over the chain's root path (one state per
      superstep).
    * ``"all"``: the reference protocol (``ess_per_s_MP.cu:265-278``):
      all P categorical draws are emitted per superstep
      (``selection="all_first"``); ESS is the sum of the per-slot stream
      ESSs and MSJD is over the iteration-major flattened stream; the
      root-path numbers are reported beside them from the same run.  With
      ``method='fused_chain'`` the cell runs the kernel's ``emit="all"``
      (P <= 512), otherwise the superstep path.  The wall clock includes
      the device-to-host emission the protocol needs (``emit_chunk``
      supersteps per device call, spooled to a memmap that is deleted
      unless ``keep_emit``) and excludes the warm-up.

    ``scale="paper"`` runs the reference's size: n = 100,000, 1,000,000
    steps, a burn-in of 2,000.  ``device``: CUDA unless given.
    """
    dev = resolve_device(device)
    Ps = as_tuple(Ps)
    algos = as_tuple(algos)
    if scale == "paper":
        n_data, num_steps, burn_in = 100000, 1_000_000, 2000
    fused_chain = method == "fused_chain"
    if chains > 1 and not fused_chain:
        raise ValueError("chains > 1 requires method='fused_chain'")
    if trace not in ("root", "all"):
        raise ValueError(f"unknown trace mode {trace!r}")
    if trace == "all" and chains > 1:
        raise ValueError("trace='all' supports chains=1 only")
    target = ess_target(n_data, seed,
                        method="fused" if fused_chain else method,
                        device=dev)
    theta0 = torch.tensor([0.0, 0.0, 1.0], device=dev)
    out = {}
    rows = []
    root_means = []
    for algo in algos:
        for P in Ps:
            if algo == "pmp":
                spec = SamplerSpec(
                    algo="pmp", N=1, depth=tree.binary_depth(P),
                    step_size=0.02, selection="all_first",
                )
            else:
                spec = SamplerSpec(
                    algo="mp", N=P - 1, step_size=0.02,
                    selection="all_first",
                )
            if trace == "all":
                cell = _emit_all_cell_fused if fused_chain else (
                    _emit_all_cell
                )
                root_e, root_m, all_e, all_m, dt = cell(
                    target, spec, theta0, num_steps, burn_in,
                    emit_chunk, out_dir, seed, keep_emit,
                    tag=f"{algo}_P{P}",
                )
                rows.append((algo, P, all_e / dt, all_m / dt, dt))
                out[f"{algo}_P{P}_all_ess_per_s"] = all_e / dt
                out[f"{algo}_P{P}_all_msjd_per_s"] = all_m / dt
                out[f"{algo}_P{P}_ess_per_s"] = root_e / dt
                out[f"{algo}_P{P}_msjd_per_s"] = root_m / dt
                continue
            if fused_chain:
                # whole chain chunks inside one kernel launch: the trace is
                # the root path the superstep path's collect records
                from pmpx_torch.kernels import fused_chain as fc

                cfg = fc.spec_to_cfg(spec)
                if chains > 1:
                    from pmpx_torch.parallel import chains as farm_mod

                    farm = farm_mod.make_chain_farm_fused(
                        target, cfg, num_steps, chunk=1000)
                    th0 = theta0.expand(chains, 3).contiguous()

                    def f(s=seed, farm=farm, th0=th0):
                        return farm(farm_mod.chain_generators(
                            s, chains, dev), th0)
                else:
                    runk = fc.make_fused_chain(target, cfg, chunk=1000)

                    def f(s=seed, runk=runk):
                        return runk(seeded(s, dev), theta0, num_steps)
            else:
                chain = compile_chain(spec.build(target), seeded(seed, dev),
                                      theta0, lambda th, o: th)

                def f(s=seed, chain=chain):
                    return chain.run(seeded(s, dev), theta0, num_steps)[1]
            f()  # warm-up (on the superstep path, the capture)
            sync(dev)
            t0 = time.perf_counter()
            roots = f()
            sync(dev)
            dt = time.perf_counter() - t0
            if chains > 1:
                rc = roots[:, burn_in:]  # (C, steps, 3)
                e = float(sum(float(ess(c[:, 0])) for c in rc))
                m = float(sum(
                    float(msjd(c)) * c.shape[0] for c in rc
                )) / dt
                key_sfx = f"_chains{chains}"
                root_means.append(rc.double().mean(dim=(0, 1)).cpu())
            else:
                r = roots[burn_in:]
                e = float(ess(r[:, 0]))
                m = float(msjd(r)) * r.shape[0] / dt
                key_sfx = ""
                root_means.append(r.double().mean(dim=0).cpu())
            rows.append((algo, P, e / dt, m, dt))
            out[f"{algo}_P{P}{key_sfx}_ess_per_s"] = e / dt
            out[f"{algo}_P{P}{key_sfx}_msjd_per_s"] = m
    arrays = {"rows": np.asarray([(r[2], r[3], r[4]) for r in rows])}
    if root_means:  # the root cells' posterior means of (b0, b1, sigma)
        arrays["root_mean"] = torch.stack(root_means).numpy()
    save_trace(
        out_dir, "ess_msjd", arrays,
        {"rows": [f"{r[0]}_P{r[1]}" for r in rows], "summary": out,
         "device": str(dev)},
    )
    # merge into any existing summary, so that the P grid can be filled by
    # separate runs without losing the cells an earlier run recorded
    sp = os.path.join(out_dir, "summary.json")
    merged = {}
    if os.path.exists(sp):
        with open(sp) as fh:
            merged = json.load(fh)
    merged.update(out)
    with open(sp, "w") as fh:
        json.dump(merged, fh, indent=2)
    render_ess_msjd(sp, out_dir)
    return out
