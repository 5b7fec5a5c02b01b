#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pmpx_torch``) on one CUDA card.

Run from the root of the repository, on a machine with an NVIDIA Hopper
card, ``nvcc`` and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, each printing its wall time:

0. the card, its power limit, the torch and nvcc versions;
1. the kernels' build (``nvcc`` into ``pmpx_torch/_build/``), with the
   registers, shared memory and spills ``ptxas`` reports;
2. ``linreg_rss`` against its plain version at the shapes the sweep
   paths give it;
3. ``fused_chain`` (injected uniforms) against its plain version, step by
   step from the kernel's own state; 3b. the same for its flat-MP and
   general modes; 3c. the same for every fused cell of the time grid, on
   the grid's own data, and for the ESS protocol's root cells on its
   target; 3d. the same for ``emit="all"`` in its three modes, slot by
   slot; 3e. the chain farm (C chains in one launch) bit-equal to C
   single-chain launches, and the ESS protocol's farm cell, chain by
   chain, against the plain version;
4. the sweep main path of the benchmark cell (``pmpx_torch.bench``), with
   its launch count and a posterior check;
5. the fused main path, likewise;
6. each kernel's time beside its plain version's and its bound (the
   launches of each from the time grid of phase 7 and the ESS protocol of
   phase 9), and the farm's supersteps per second against its chain
   count;
7. the time grid of the reference (``pmpx_torch.experiments.
   time_analysis``) at full width on both paths, with a posterior check of
   a flat-MP and a general fused chain;
8. ``cores_sweep`` on the fused path for PMP and MP, its wall budget cut
   to ``CORES_SET_TIME`` seconds per P (the one reduction);
9. the ESS/MSJD protocol (``pmpx_torch.experiments.ess_msjd``) at the
   paper's data size on the fused path, every slot's draws and the root
   path, one farm of chains, and the superstep path's emit-all cells, with
   the cuts listed in its JSON line.

It ends with a ``{"kernels": [...]}`` line, the card's name and power
limit as ``nvidia-smi`` gives them, and ``{"ok": true, ...}`` as the last
line.  Any failed check raises, so the script exits non-zero and prints no
``ok``.  Without a CUDA card it fails at once.  It imports nothing of JAX
or of the ``pmpx`` package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet).
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

RSS_TOL = 1e-5  # relative to max|rss|: f32 sums of ~1e5 terms, two orders
CHAIN_ATOL = 1e-4
CHAIN_AGREE = 0.99

SWEEP_BURN = 500  # of bench.SWEEP_ITERS = 2000 supersteps
FUSED_BURN = 10_000  # of bench.FUSED_ITERS = 100,000

# phase 3b: (N, depth) of the flat-MP and general modes; the grid's flat
# P = 4 and P = 1024, P = 200 (lanes above P), conv_pmp's N = 7 x depth 3
# (P = 512) and the largest base the general kernel takes at P = 1024
NEW_MODES = ((3, 1), (199, 1), (1023, 1), (3, 2), (7, 3), (31, 2))
# phase 2: (P, n) of linreg_rss: the bench cell's P = 1024 and the time
# grid's P = 4 (padded to 8) and P = 1024 at n = 500 and 100,000; P = 200
# and P = 8 at other sizes; the ESS protocol's sweep cells, P = 512 and 8
# at n = 100,000
RSS_SHAPES = ((1024, 100_000), (1024, 500), (4, 100_000), (4, 500),
              (200, 100_000), (8, 5000), (512, 100_000), (8, 100_000))
# phase 3c: (N, depth) of the time grid's fused cells: PMP P = 4 (depth 2,
# lanes above P) and P = 1024, MP P = 4 and P = 1024, conv_pmp's N = 7 x 3;
# and of the ESS protocol's root cells (phase 9, on its target): binary and
# flat MP at P = 8, 32, 128, 512
GRID_FUSED = ((1, 2), (1, 10), (3, 1), (1023, 1), (7, 3))
ESS_FUSED = ((1, 3), (1, 5), (1, 7), (1, 9), (7, 1), (31, 1), (127, 1),
             (511, 1))
POSTERIOR_STEPS = 50_000  # phase 7's flat-MP and general posterior chains
POSTERIOR_BURN = 10_000
# phase 8: the wall budget per P (pmpx's default is 5 s, the paper's 180)
CORES_SET_TIME = 2.0
# phase 3d: (N, depth) of emit="all": binary and flat MP at P = 8, 32, 128,
# 512 (the ESS protocol's grid), general (3, 2) and conv_pmp's (7, 3).
# Gates: CHAIN_AGREE of the slot draws equal; the state and the last
# slot's within CHAIN_ATOL where their draws agree; the jump sum within
# CHAIN_ATOL of max(1, J) where every slot agrees; slot 0's b0 bit-equal
# to the state's.
EMIT_SHAPES = ((1, 3), (1, 5), (1, 7), (1, 9), (7, 1), (31, 1), (127, 1),
               (511, 1), (3, 2), (7, 3))
# phase 3e: the farm of FARM_C chains at P = 8 and 512 (binary) and flat MP
# P = 512 bit-equal to single chains; the ESS protocol's farm cell (ESS_CHAINS
# chains of binary P = 512, FARM_STEPS supersteps a launch) on injected
# uniforms against the plain version, with phase 3's gates; phase 6: its
# throughput against the chain count
FARM_C = 4
FARM_STEPS = 1000
FARM_SHAPES = ((1, 3), (1, 9), (511, 1))
FARM_COUNTS = (1, 8, 32, 132, 264)
# phase 9: the ESS protocol at the paper's n = 100,000; cut: 20,000 steps
# (the paper's 1,000,000) with its burn-in of 2,000; the superstep path's
# emit-all cells at P = 8 and 512 only, 1000 steps with a burn-in of 200
ESS_N = 100_000
ESS_PS = (8, 32, 128, 512)
ESS_STEPS = 20_000
ESS_BURN = 2_000
ESS_CHAINS = 8
ESS_SWEEP_PS = (8, 512)
ESS_SWEEP_STEPS = 1000
ESS_SWEEP_BURN = 200


class Phase:
    """Prints the phase's wall time when it ends, failed or not."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        print(f"== {self.name}", flush=True)
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        status = "FAILED" if exc_type else "ok"
        print(f"== {self.name}: {status}, {dt:.3f} s wall", flush=True)
        return False


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def run_tool(cmd: list[str]) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=30)
    if res.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed: {res.stderr}")
    return res.stdout.strip()


def event_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean ms of fn() on the card over ``reps`` calls, after one warm-up
    unless ``warmup`` is False."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def chain_ops(P: int, depth: int, steps: int, n_slots: int) -> float:
    """f32 operations of one fused_chain launch, counted from the kernel
    (a transcendental counts as one): per node and superstep, Box-Muller
    3 x 7, positions 3 adds per set bit (depth/2 on average), log-density
    15, walk 7 per level, weights, scan and count 4; per launch, 8 per data
    slot for the statistics."""
    per_node = 21 + 1.5 * depth + 15 + 7 * depth + 4
    return P * steps * per_node + 8 * n_slots


def chain_mp_ops(P: int, steps: int, n_slots: int) -> float:
    """f32 operations of one fused_chain_mp launch, counted from the
    kernel (a transcendental counts as one): per node and superstep,
    Box-Muller 3 x 7, position 3, log-density 15, the MTM weight 26
    (|S|^2 5, its share of the 4 block sums 4, S.G 5, the distance 4, the
    weight 2, max 1, exp-sum 2, log-softmax 3), weights, scan and count 4;
    per launch, 8 per data slot for the statistics."""
    per_node = 21 + 3 + 15 + 26 + 4
    return P * steps * per_node + 8 * n_slots


def chain_general_ops(N: int, depth: int, steps: int, n_slots: int) -> float:
    """f32 operations of one fused_chain_general launch, counted from the
    kernel: per node and superstep, Box-Muller 3 x 7, positions 3 per
    nonzero digit (depth (1 - 1/base) on average) and 3 for theta,
    log-density 15, |S|^2 5, weights, scan and count 4; per level i, each
    of the m_i = base^(i+1) nodes of the level adds 9 per sibling for the
    group sums and 14 for its weight, max and exp (base 6 + 3 more per
    sibling than a count of the sums alone: the squares are recomputed), and
    every node adds base + 5 for its group total and level factor; per
    launch, 8 per data slot."""
    base = N + 1
    P = base**depth
    per_node = 21 + 3 * depth * (1 - 1 / base) + 3 + 15 + 5 + 4
    levels = sum(base ** (i + 1) * (9 * base + 14) for i in range(depth))
    levels += P * depth * (base + 5)
    return steps * (P * per_node + levels) + 8 * n_slots


def emit_ops(P: int, steps: int) -> float:
    """The f32 operations emit="all" adds to a chain launch, per slot and
    superstep: a binary search of the cdf (2 log2 P compares and index
    steps), its threshold 1, the jump from the previous slot 9 (3
    differences, 3 squares, 2 adds, the block sum's add); the 3P gathers
    and P stored floats are bytes, counted by the caller."""
    return steps * P * (2.0 * math.log2(P) + 1 + 9)


def lstm_fused_bound(P: int = 8, B: int = 60_000, T: int = 28, F: int = 28,
                     H: int = 64) -> dict:
    """The bound of pmpx/kernels/lstm_fused.py (not ported yet) at the
    MNIST-LSTM protocol's shapes: P = 8 parameter sets (N = 7, a binary
    tree of 8 states), the full batch B = 60,000, T = F = 28, H = 64
    (lstm_final_hidden, lstm_fused.py:83-115).  8 H (F + H) T flops per
    parameter set and example (the two gate matmuls); bytes: x (T, B, F)
    read once, the P weight sets read once, (P, B, H) written, all f32.
    Against f32 on the CUDA cores and against bf16 inputs on the tensor
    cores (989 TFLOP/s)."""
    flops = 8.0 * H * (F + H) * T * P * B
    nbytes = 4.0 * (T * B * F + P * (F * 4 * H + H * 4 * H + 4 * H)
                    + P * B * H)
    b_ms, b_by = bound(flops, nbytes)
    return {"name": "lstm_fused", "replaces": "pmpx/kernels/lstm_fused.py:48",
            "P": P, "B": B, "flops": flops, "bytes": nbytes,
            "bound_ms_f32": b_ms, "bound_by_f32": b_by,
            "bound_ms_bf16_tensor": max(flops / 989e12,
                                        nbytes / 2 / PEAK_BYTES_PER_S) * 1e3}


def chain_vs_plain(fc, label, target, theta0, consts, seed, steps=100,
                   chunks=2) -> float:
    """``chunks`` launches of ``steps`` supersteps of fc.chain_chunk on
    injected uniforms, each superstep held against the plain version's
    from the kernel's own previous state (fc.replay_against_plain).
    Requires CHAIN_AGREE of the selections equal and the states within
    CHAIN_ATOL where they are; returns that max |err|."""
    dev = theta0.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    uin = 1.0 - torch.rand(
        (chunks, steps * fc.U_ROWS, fc.lane_extent(consts["P"])),
        generator=gen, device=dev)
    _, _, agree, err, misses = fc.replay_against_plain(
        target.x2d, target.y2d, theta0, uin, **consts)
    for t, k, kk, u, lo, hi in misses:
        print(f"step {t}: plain picks {k}, kernel {kk}; u = {u:.9g}, "
              f"plain cdf[k-1], cdf[k] = {lo:.9g}, {hi:.9g}")
    n_steps = steps * chunks
    print(f"{label} (P={consts['P']}): {agree}/{n_steps} selections agree; "
          f"max|err| of the state where they do: {err:.3g}")
    require(agree >= CHAIN_AGREE * n_steps, f"{label} selections")
    require(err <= CHAIN_ATOL, f"{label} trace atol")
    return err


def posterior_check(name, trace, burn, target, bench) -> None:
    ls, sd = bench.least_squares(target)
    mean = trace[burn:, :2].double().mean(0).cpu()
    z = ((mean - ls) / sd).abs()
    print(f"{name}: posterior mean (b0, b1) = {mean.tolist()}, "
          f"least squares = {ls.tolist()}, posterior sd = {sd.tolist()}, "
          f"|z| = {z.tolist()}")
    require(bool(torch.isfinite(trace).all()), f"{name}: finite trace")
    require(bool((z < 4.0).all()), f"{name}: mean within 4 sd of the fit")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1

    import pmpx_torch  # sets the f32 numerics
    here = Path(__file__).resolve().parent
    if Path(pmpx_torch.__file__).resolve().parent.parent != here:
        raise RuntimeError(f"pmpx_torch was imported from "
                           f"{pmpx_torch.__file__}, not from {here}")
    from pmpx_torch import _build, bench
    from pmpx_torch.config import SamplerSpec
    from pmpx_torch.experiments import ess_msjd, time_analysis
    from pmpx_torch.kernels import fused_chain as fc
    from pmpx_torch.metrics.recorder import load_trace
    from pmpx_torch.parallel import chains as farm_mod
    from pmpx_torch.kernels import launches, reset_launches
    from pmpx_torch.kernels.linreg import (
        batched_rss, batched_rss_ref, pad_proposals,
    )
    from pmpx_torch.samplers import pmp
    from pmpx_torch.targets.linreg import make_synthetic_linreg, pad_to_grid

    t_start = time.perf_counter()
    dev = torch.device("cuda")

    with Phase("0 device"):
        name = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = run_tool(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"]).splitlines()[0]
        nvcc = run_tool([_build.nvcc_path(), "--version"]).splitlines()[-1]
        print(f"device: {name} x{count}; nvidia-smi: {smi}")
        print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); "
              f"python {sys.version.split()[0]}; nvcc: {nvcc}")

    with Phase("1 build"):
        built = _build.load()
        when = ("by an earlier run" if built.seconds is None
                else f"in {built.seconds:.3f} s")
        print(f"library {built.path.name}: built {when}")
        for line in built.log.splitlines():
            if "ptxas" in line or "spill" in line or "Used" in line:
                print("  " + line.strip())

    with Phase("2 linreg_rss vs plain"):
        rss_err = 0.0
        for P, n in RSS_SHAPES:
            gen = torch.Generator(device=dev)
            gen.manual_seed(100 + P)
            x, y = make_synthetic_linreg(gen, n)
            x2d, y2d = pad_to_grid(x), pad_to_grid(y)
            b0 = -1.0 + 0.3 * torch.randn(P, generator=gen, device=dev)
            b1 = 2.0 + 0.3 * torch.randn(P, generator=gen, device=dev)
            b0p, b1p, _ = pad_proposals(b0, b1)
            got = batched_rss(b0p, b1p, x2d, y2d)
            want = batched_rss_ref(b0p, b1p, x2d, y2d)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            print(f"P={P} (padded {b0p.shape[0]}), n={n} "
                  f"({x2d.numel()} slots): max|err| {err:.6g}, "
                  f"max|rss| {scale:.6g}, rel {err / scale:.3g}")
            require(err <= RSS_TOL * scale, f"linreg_rss P={P} n={n}")
            rss_err = max(rss_err, err)

    target = bench.bench_target(dev)
    cfg = bench.bench_config()
    P, depth = cfg.P, cfg.depth
    L = fc.lane_extent(P)
    consts = dict(P=P, depth=depth, n_data=float(target.n),
                  temper=target.temper, step_size=cfg.step_size)

    # max |err| of the state, per mode, over phases 3, 3b and 3c
    mode_err = {"binary": 0.0, "mp": 0.0, "general": 0.0}

    with Phase("3 fused_chain vs plain"):
        mode_err["binary"] = chain_vs_plain(
            fc, "fused_chain", target, bench.theta0(dev), consts, seed=3)

    with Phase("3b fused_chain mp and general vs plain"):
        for N, d in NEW_MODES:
            mode = "mp" if d == 1 else "general"
            kw = dict(consts, P=(N + 1) ** d, depth=d, mode=mode, N=N,
                      trans_sigma=cfg.trans_sigma, trans_norm=1.0)
            err = chain_vs_plain(fc, f"fused_chain_{mode} N={N} depth={d}",
                                 target, bench.theta0(dev), kw,
                                 seed=30 + N + d)
            mode_err[mode] = max(mode_err[mode], err)

    # the ESS protocol's target (phases 3c-3e, 6 and 9): n = 100,000,
    # temper 1/2000, the data run() draws from seed 0
    et = ess_msjd.ess_target(ESS_N, device=dev)

    with Phase("3c the time grid's and the ESS protocol's fused cells vs "
               "plain"):
        for n in (500, 100_000):
            gt = time_analysis.grid_target(n, device=dev)
            for N, d in GRID_FUSED:
                spec = SamplerSpec(algo="mp" if d == 1 else "pmp", N=N,
                                   depth=d, step_size=0.02,
                                   selection="all_first")
                kw = fc.chain_consts(gt, fc.spec_to_cfg(spec))
                err = chain_vs_plain(
                    fc, f"{fc.KERNEL_NAME[kw['mode']]} N={N} depth={d} "
                    f"n={n}", gt, bench.theta0(dev), kw, seed=n + N + d)
                mode_err[kw["mode"]] = max(mode_err[kw["mode"]], err)
        for N, d in ESS_FUSED:
            kw = fc.chain_consts(et, pmp.PMPConfig(
                N=N, depth=d, step_size=0.02, selection="all_first"))
            err = chain_vs_plain(
                fc, f"{fc.KERNEL_NAME[kw['mode']]} N={N} depth={d} "
                f"n={ESS_N} (ESS target)", et, bench.theta0(dev), kw,
                seed=3000 + N + d)
            mode_err[kw["mode"]] = max(mode_err[kw["mode"]], err)
    # max |err| of the state per emit="all" mode (phase 3d)
    emit_err = {"binary": 0.0, "mp": 0.0, "general": 0.0}

    with Phase("3d fused_chain emit='all' vs plain"):
        for N, d in EMIT_SHAPES:
            ecfg = pmp.PMPConfig(N=N, depth=d, step_size=0.02,
                                 selection="all_first")
            kw = fc.chain_consts(et, ecfg)
            gen = torch.Generator(device=dev)
            gen.manual_seed(300 + N + d)
            L_e = fc.lane_extent(kw["P"])
            uin = 1.0 - torch.rand((2, 100 * fc.U_ROWS, L_e), generator=gen,
                                   device=dev)
            uemit = 1.0 - torch.rand((2, 100, L_e), generator=gen,
                                     device=dev)
            out = fc.replay_emit_against_plain(
                et.x2d, et.y2d, bench.theta0(dev), uin, uemit, **kw)
            label = f"{fc.KERNEL_NAME_ALL[kw['mode']]} N={N} depth={d}"
            for miss in out["misses"][:5]:
                print(f"{label}: step {miss[0]} slot {miss[1]}: plain draws "
                      f"node {miss[2]}, kernel {miss[3]}")
            print(f"{label} (P={kw['P']}): {out['slots_agree']}/"
                  f"{out['slots']} slot draws agree over 200 supersteps; "
                  f"max|err| of the states {out['state_err']:.3g}, of the "
                  f"jump sums {out['jump_err']:.3g} (relative to "
                  f"max(1, J)); slot 0 b0 bit-equal to the state's: "
                  f"{out['b0_root_equal']}")
            require(out["slots_agree"] >= CHAIN_AGREE * out["slots"],
                    f"{label} slot draws")
            require(out["state_err"] <= CHAIN_ATOL, f"{label} states")
            require(out["jump_err"] <= CHAIN_ATOL, f"{label} jump sums")
            require(out["b0_root_equal"], f"{label} emit_b0[0] == root b0")
            emit_err[kw["mode"]] = max(emit_err[kw["mode"]],
                                       out["state_err"])

    with Phase("3e chain farm vs single chains and plain"):
        th_farm = torch.tensor([[0.0, 0.0, 1.0], [-1.0, 2.0, 0.5],
                                [0.5, -0.5, 1.5], [-2.0, 1.0, 0.8]],
                               device=dev)[:FARM_C]
        for N, d in FARM_SHAPES:
            fcfg = pmp.PMPConfig(N=N, depth=d, step_size=0.02,
                                 selection="all_first")
            farm = farm_mod.make_chain_farm_fused(et, fcfg, 1000, chunk=500)
            got = farm(farm_mod.chain_generators(11, FARM_C, dev), th_farm)
            single = fc.make_fused_chain(et, fcfg, chunk=500)
            gens = farm_mod.chain_generators(11, FARM_C, dev)
            for c in range(FARM_C):
                require(torch.equal(got[c], single(gens[c], th_farm[c], 1000)),
                        f"farm chain {c} of N={N} depth={d} bit-equal to "
                        f"its single chain")
            require(bool(torch.isfinite(got).all()), "finite farm roots")
            print(f"farm of {FARM_C} chains, N={N} depth={d} "
                  f"(P={fcfg.P}), 2 launches of 500 supersteps: every chain "
                  f"bit-equal to its single-chain run")
        # phase 9's farm cell at its own shape, on injected uniforms
        fcfg = pmp.PMPConfig(N=1, depth=9, step_size=0.02,
                             selection="all_first")
        kw = fc.chain_consts(et, fcfg)
        farm = farm_mod.make_chain_farm_fused(et, fcfg, FARM_STEPS,
                                              chunk=FARM_STEPS, rng="input")
        gen = torch.Generator(device=dev)
        gen.manual_seed(39)
        th_cell = bench.theta0(dev).expand(ESS_CHAINS, 3).contiguous()
        uin_f = 1.0 - torch.rand(
            (1, ESS_CHAINS, FARM_STEPS * fc.U_ROWS, fc.lane_extent(kw["P"])),
            generator=gen, device=dev)
        before = launches[fc.FARM_KERNEL]
        roots = farm(farm_mod.chain_generators(39, ESS_CHAINS, dev), th_cell,
                     uin=uin_f)
        require(launches[fc.FARM_KERNEL] == before + 1,
                "the farm cell in one launch")
        farm_err = 0.0
        for c in range(ESS_CHAINS):
            agree, err, misses = fc.replay_roots_against_plain(
                et.x2d, et.y2d, th_cell[c], uin_f[0, c], roots[c], **kw)
            for t, k, kk, u, lo, hi in misses:
                print(f"farm chain {c} step {t}: plain picks {k}, kernel "
                      f"{kk}; u = {u:.9g}, plain cdf[k-1], cdf[k] = "
                      f"{lo:.9g}, {hi:.9g}")
            print(f"farm of {ESS_CHAINS}, chain {c} (P={kw['P']}): "
                  f"{agree}/{FARM_STEPS} selections agree with the plain "
                  f"version; max|err| of the state where they do: {err:.3g}")
            require(agree >= CHAIN_AGREE * FARM_STEPS,
                    f"farm chain {c} selections")
            require(err <= CHAIN_ATOL, f"farm chain {c} trace atol")
            farm_err = max(farm_err, err)

    with Phase("4 sweep main path"):
        sweep_us, sweep_trace = bench.time_sweep(
            target, cfg, before_timed=reset_launches)
        sweep_counts = dict(launches)
        print(f"sweep: {sweep_us:.3f} us/iter over {bench.SWEEP_ITERS} "
              f"supersteps (CUDA events); launches {sweep_counts}")
        require(sweep_counts["linreg_rss"] == bench.SWEEP_ITERS,
                "one linreg_rss launch per superstep")
        posterior_check("sweep", sweep_trace, SWEEP_BURN, target, bench)

    with Phase("5 fused main path"):
        fused_us, fused_trace = bench.time_fused(
            target, cfg, before_timed=reset_launches)
        fused_counts = dict(launches)
        print(f"fused: {fused_us:.4f} us/iter over {bench.FUSED_ITERS} "
              f"supersteps (CUDA events); launches {fused_counts}")
        require(fused_counts["fused_chain"]
                == bench.FUSED_ITERS // bench.FUSED_CHUNK,
                "one fused_chain launch per chunk")
        posterior_check("fused", fused_trace, FUSED_BURN, target, bench)

    with Phase("6 kernel times"):
        kernels = []
        # linreg_rss at the sweep's shape: P = 1024 positions of one tree
        g = torch.Generator(device=dev)
        g.manual_seed(6)
        th = sweep_trace[-1]
        b0 = (th[0] + 0.05 * torch.randn(P, generator=g, device=dev))
        b1 = (th[1] + 0.05 * torch.randn(P, generator=g, device=dev))
        x2d, y2d = target.x2d, target.y2d
        n_slots = x2d.numel()
        ms = event_ms(lambda: batched_rss(b0, b1, x2d, y2d), 200)
        plain_ms = event_ms(lambda: batched_rss_ref(b0, b1, x2d, y2d), 5)
        b_ms, b_by = bound(5.0 * P * n_slots, 4.0 * (2 * n_slots + 3 * P))
        kernels.append({
            "name": "linreg_rss", "route": "cuda",
            "source": "pmpx_torch/csrc/linreg_rss.cu",
            "replaces": "pmpx/kernels/linreg.py:54",
            "launches": sweep_counts["linreg_rss"],
            "max_abs_err": rss_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
        })

        # fused_chain: one launch of the fused path's chunk
        chunk = bench.FUSED_CHUNK
        seed = torch.tensor([12345], dtype=torch.int32, device=dev)
        th0 = bench.theta0(dev)
        ms = event_ms(lambda: fc.chain_chunk(
            x2d, y2d, th0, steps=chunk, seed=seed, **consts), 5)
        uin1 = 1.0 - torch.rand((chunk * fc.U_ROWS, L), generator=g,
                                device=dev)
        ms_input = event_ms(lambda: fc.chain_chunk(
            x2d, y2d, th0, steps=chunk, uin=uin1, **consts), 5)
        plain_ms = event_ms(lambda: fc.fused_chain_ref(
            x2d, y2d, th0, uin1, **consts), 1)
        nbytes = 4.0 * (2 * n_slots + 4 * chunk + 6 + 1)
        b_ms, b_by = bound(chain_ops(P, depth, chunk, n_slots), nbytes)
        kernels.append({
            "name": "fused_chain", "route": "cuda",
            "source": "pmpx_torch/csrc/fused_chain.cu",
            "replaces": "pmpx/kernels/fused_chain.py:184",
            "launches": fused_counts["fused_chain"],
            "max_abs_err": mode_err["binary"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "ms_rng_input": ms_input, "steps_per_launch": chunk, "P": P,
        })
        # fused_chain_mp and fused_chain_general: one launch of the same
        # chunk at the grid's flat P = 1024 and conv_pmp's P = 512 tree
        for kname, N_k, d_k in (("fused_chain_mp", 1023, 1),
                                ("fused_chain_general", 7, 3)):
            mode = "mp" if d_k == 1 else "general"
            kw = dict(consts, P=(N_k + 1) ** d_k, depth=d_k, mode=mode,
                      N=N_k, trans_sigma=cfg.trans_sigma, trans_norm=1.0)
            uin_k = 1.0 - torch.rand((chunk * fc.U_ROWS,
                                      fc.lane_extent(kw["P"])),
                                     generator=g, device=dev)
            ms = event_ms(lambda kw=kw: fc.chain_chunk(
                x2d, y2d, th0, steps=chunk, seed=seed, **kw), 5)
            ms_input = event_ms(lambda kw=kw, u=uin_k: fc.chain_chunk(
                x2d, y2d, th0, steps=chunk, uin=u, **kw), 5)
            plain_ms = event_ms(lambda kw=kw, u=uin_k: fc.fused_chain_ref(
                x2d, y2d, th0, u, **kw), 1)
            ops = (chain_mp_ops(kw["P"], chunk, n_slots) if mode == "mp"
                   else chain_general_ops(N_k, d_k, chunk, n_slots))
            b_ms, b_by = bound(ops, nbytes)
            kernels.append({
                "name": kname, "route": "cuda",
                "source": "pmpx_torch/csrc/fused_chain.cu",
                "replaces": "pmpx/kernels/fused_chain.py:184",
                "launches": None,  # from the time grid, phase 7
                "max_abs_err": mode_err[mode],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None,
                "ms_rng_input": ms_input, "steps_per_launch": chunk,
                "P": kw["P"],
            })
        # emit="all" at the ESS protocol's largest P = 512, one
        # 1000-superstep launch on its target, beside emit="root" at the
        # same shape
        et_slots = et.x2d.numel()
        steps_e = 1000
        for kname, N_k, d_k in (("fused_chain_all", 1, 9),
                                ("fused_chain_mp_all", 511, 1),
                                ("fused_chain_general_all", 7, 3)):
            kw = fc.chain_consts(et, pmp.PMPConfig(
                N=N_k, depth=d_k, step_size=0.02, selection="all_first"))
            P_k = kw["P"]
            L_k = fc.lane_extent(P_k)
            uin_k = 1.0 - torch.rand((steps_e * fc.U_ROWS, L_k),
                                     generator=g, device=dev)
            uem_k = 1.0 - torch.rand((steps_e, L_k), generator=g,
                                     device=dev)
            ms = event_ms(lambda kw=kw: fc.chain_chunk(
                et.x2d, et.y2d, th0, steps=steps_e, seed=seed, emit="all",
                **kw), 5)
            ms_root = event_ms(lambda kw=kw: fc.chain_chunk(
                et.x2d, et.y2d, th0, steps=steps_e, seed=seed, **kw), 5)
            ms_input = event_ms(lambda kw=kw, u=uin_k, e=uem_k:
                                fc.chain_chunk(et.x2d, et.y2d, th0,
                                               steps=steps_e, uin=u,
                                               uemit=e, emit="all", **kw), 5)
            plain_ms = event_ms(lambda kw=kw, u=uin_k, e=uem_k:
                                fc.fused_chain_ref(et.x2d, et.y2d, th0, u,
                                                   uemit=e, **kw), 1)
            if kw["mode"] == "binary":
                ops = chain_ops(P_k, d_k, steps_e, et_slots)
            elif kw["mode"] == "mp":
                ops = chain_mp_ops(P_k, steps_e, et_slots)
            else:
                ops = chain_general_ops(N_k, d_k, steps_e, et_slots)
            ops += emit_ops(P_k, steps_e)
            # grids read once; per superstep the 8-row trace and P emitted
            # b0 written; the seed and states
            nbytes = 4.0 * (2 * et_slots + (8 + P_k) * steps_e + 6 + 1)
            b_ms, b_by = bound(ops, nbytes)
            kernels.append({
                "name": kname, "route": "cuda",
                "source": "pmpx_torch/csrc/fused_chain.cu",
                "replaces": "pmpx/kernels/fused_chain.py:348",
                "launches": None,  # from the ESS protocol, phase 9
                "max_abs_err": emit_err[kw["mode"]],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None,
                "ms_rng_input": ms_input, "ms_emit_root": ms_root,
                "steps_per_launch": steps_e, "P": P_k,
            })

        # the farm: ESS_CHAINS chains of binary P = 512 in one
        # 1000-superstep launch (phase 9's farm cell), beside its plain
        # version (each chain's plain loop)
        kw = fc.chain_consts(et, pmp.PMPConfig(
            N=1, depth=9, step_size=0.02, selection="all_first"))
        thC = bench.theta0(dev).expand(ESS_CHAINS, 3).contiguous()
        seedsC = torch.arange(ESS_CHAINS, dtype=torch.int32, device=dev)
        ms = event_ms(lambda: fc.chain_chunk(
            et.x2d, et.y2d, thC, steps=steps_e, seed=seedsC, **kw), 5)
        uinC = 1.0 - torch.rand((ESS_CHAINS, steps_e * fc.U_ROWS, 512),
                                generator=g, device=dev)
        plain_ms = event_ms(lambda: [fc.fused_chain_ref(
            et.x2d, et.y2d, thC[c], uinC[c], **kw)
            for c in range(ESS_CHAINS)], 1, warmup=False)
        ops = ESS_CHAINS * chain_ops(512, 9, steps_e, 0) + 8 * et_slots
        nbytes = 4.0 * (2 * et_slots + ESS_CHAINS * (4 * steps_e + 6 + 1))
        b_ms, b_by = bound(ops, nbytes)
        kernels.append({
            "name": "fused_chain_farm", "route": "cuda",
            "source": "pmpx_torch/csrc/fused_chain.cu",
            "replaces": "pmpx/kernels/fused_chain.py:184",
            "farm_of": "pmpx/parallel/chains.py:83",
            "launches": None,  # from the ESS protocol's farm cell, phase 9
            "max_abs_err": farm_err,  # against plain, phase 3e
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "steps_per_launch": steps_e, "P": 512, "chains": ESS_CHAINS,
        })

        # the farm's throughput: supersteps per second of the whole card
        # against the chain count, one 1000-superstep launch each
        farm_curve = []
        for N_k, d_k in ((1, 3), (1, 9)):
            kw = fc.chain_consts(et, pmp.PMPConfig(
                N=N_k, depth=d_k, step_size=0.02, selection="all_first"))
            for C in FARM_COUNTS:
                thC = bench.theta0(dev).expand(C, 3).contiguous()
                seedsC = torch.arange(C, dtype=torch.int32, device=dev)
                ms = event_ms(lambda kw=kw, t=thC, sd=seedsC: fc.chain_chunk(
                    et.x2d, et.y2d, t, steps=steps_e, seed=sd, **kw), 3)
                farm_curve.append({
                    "P": kw["P"], "chains": C, "ms_per_launch": ms,
                    "supersteps_per_s": C * steps_e / (ms * 1e-3)})
                print(f"farm P={kw['P']} C={C}: {ms:.6g} ms per "
                      f"{steps_e}-superstep launch, "
                      f"{C * steps_e / (ms * 1e-3):.6g} supersteps/s")
        print(json.dumps({"farm_throughput": farm_curve, "device": name,
                          "power": smi}))

        for k in kernels:
            print(f"{k['name']}: {k['ms']:.6g} ms/launch, plain "
                  f"{k['plain_ms']:.6g} ms, bound {k['bound_ms']:.6g} ms "
                  f"({k['bound_by']})")
        print(json.dumps({"not_ported": [lstm_fused_bound()]}))

    with Phase("7 time grid"):
        with tempfile.TemporaryDirectory() as tmp:
            reset_launches()
            grid_sweep = time_analysis.run(method="sweep", out_dir=tmp,
                                           device=dev)
            grid_counts = {"linreg_rss": launches["linreg_rss"]}
            reset_launches()
            grid_fused = time_analysis.run(
                method="fused_chain", include_conv_pmp=True, out_dir=tmp,
                device=dev)
            grid_counts.update({k: launches[k]
                                for k in fc.KERNEL_NAME.values()})
        print(json.dumps({"time_analysis": "sweep", **grid_sweep}))
        print(json.dumps({"time_analysis": "fused_chain", **grid_fused}))
        print(f"launches in the grid: {grid_counts}")
        for kname, n in grid_counts.items():
            require(n > 0, f"the time grid launched {kname}")
        methods = {k: v for k, v in grid_fused.items()
                   if k.endswith("_method")}
        require(len(methods) == 10, "10 fused cells (2 sizes x 5)")
        require(set(methods.values()) == {"fused_chain"},
                f"every fused cell on fused_chain: {methods}")
        for key in ("mp_n100000_P1024_method",
                    "pmp_general_N7_D3_n100000_P512_method"):
            require(key in methods, key)
        for grid in (grid_sweep, grid_fused):
            for k, v in grid.items():
                if k.endswith("_us") and not k.endswith("overhead_us"):
                    require(math.isfinite(v) and v > 0, f"{k} = {v}")
        for k in kernels:
            if k["name"] in grid_counts:
                k["launches"] = grid_counts[k["name"]]

        # posterior check of a flat-MP and a general fused chain at the
        # grid's n = 100,000 (the bench cell's data and temper)
        for label, N_k, d_k in (("mp P=1024", 1023, 1),
                                ("general N=7 depth=3", 7, 3)):
            pcfg = pmp.PMPConfig(N=N_k, depth=d_k, step_size=0.02,
                                 selection="all_first")
            run = fc.make_fused_chain(target, pcfg, chunk=bench.FUSED_CHUNK)
            gen = torch.Generator(device=dev)
            gen.manual_seed(7)
            trace = run(gen, bench.theta0(dev), POSTERIOR_STEPS)
            posterior_check(f"fused {label}", trace, POSTERIOR_BURN, target,
                            bench)

    with Phase("8 cores_sweep"):
        from pmpx_torch.experiments import cores_sweep

        cores = {}
        with tempfile.TemporaryDirectory() as tmp:
            for algo in ("pmp", "mp"):
                reset_launches()
                out = cores_sweep.run(
                    n_data=100_000, Ps=(4, 1024), set_time=CORES_SET_TIME,
                    algo=algo, method="fused_chain", out_dir=tmp,
                    device=dev)
                counts = {k: v for k, v in launches.items() if v}
                cores[algo] = {**out, "launches": counts}
                for P_k in (4, 1024):
                    require(out[f"P{P_k}_iters"] > 0
                            and math.isfinite(out[f"P{P_k}_err"]),
                            f"cores_sweep {algo} P={P_k}")
                require(counts.get("fused_chain_mp" if algo == "mp"
                                   else "fused_chain", 0) > 0,
                        f"cores_sweep {algo} went through its kernel")
        print(json.dumps({
            "cores_sweep": cores, "n_data": 100_000,
            "reduced": f"wall budget {CORES_SET_TIME} s per P (pmpx's "
                       "default 5 s, the reference's 180 s)",
        }))

    with Phase("9 ess_msjd"):
        ess_runs = {}
        with tempfile.TemporaryDirectory() as tmp:
            def drive(label, **kw):
                """One run() of the protocol, its launches counted from 0."""
                reset_launches()
                out = ess_msjd.run(n_data=ESS_N, out_dir=f"{tmp}/{label}",
                                   device=dev, **kw)
                counts = {k: v for k, v in launches.items() if v}
                saved = load_trace(f"{tmp}/{label}/ess_msjd.npz")
                with open(f"{tmp}/{label}/ess_msjd.json") as fh:
                    cells = json.load(fh)["rows"]
                wall = dict(zip(cells, saved["rows"][:, 2].tolist()))
                ess_runs[label] = {"summary": out, "launches": counts}
                print(json.dumps({"ess_msjd": label, **out,
                                  "launches": counts, "wall_s": wall}))
                for k, v in out.items():
                    require(math.isfinite(v) and v > 0, f"{label}: {k} = {v}")
                return out, counts, saved

            fused = dict(Ps=ESS_PS, num_steps=ESS_STEPS, burn_in=ESS_BURN,
                         method="fused_chain")
            n_launch_all = 2 * len(ESS_PS) * ESS_STEPS // 500
            n_launch_root = 2 * len(ESS_PS) * ESS_STEPS // 1000
            _, counts, _ = drive("fused_all", trace="all", **fused)
            require(counts == {"fused_chain_all": n_launch_all,
                               "fused_chain_mp_all": n_launch_all},
                    f"the emit-all cells all on fused_chain: {counts}")
            _, counts, saved = drive("fused_root", trace="root", **fused)
            require(counts == {"fused_chain": n_launch_root,
                               "fused_chain_mp": n_launch_root},
                    f"the root cells all on fused_chain: {counts}")
            # the posterior mean of (b0, b1) at P = 512, both algorithms
            ls, sd = bench.least_squares(et)
            for i, algo in enumerate(("mp", "pmp")):
                row = i * len(ESS_PS) + ESS_PS.index(512)
                mean = torch.tensor(saved["root_mean"][row, :2])
                z = ((mean - ls) / sd).abs()
                print(f"ess_msjd {algo} P=512: posterior mean (b0, b1) = "
                      f"{mean.tolist()}, least squares = {ls.tolist()}, "
                      f"sd = {sd.tolist()}, |z| = {z.tolist()}")
                require(bool((z < 4.0).all()),
                        f"ess_msjd {algo} P=512 mean within 4 sd")
            _, counts, _ = drive("fused_chains8", trace="root",
                                 chains=ESS_CHAINS, algos=("pmp",),
                                 **dict(fused, Ps=(512,)))
            require(counts == {"fused_chain_farm": 2 * ESS_STEPS // 1000},
                    f"the farm cell in one launch per chunk: {counts}")
            _, counts, _ = drive("sweep_all", trace="all", method="sweep",
                                 Ps=ESS_SWEEP_PS, num_steps=ESS_SWEEP_STEPS,
                                 burn_in=ESS_SWEEP_BURN)
            require(set(counts) == {"linreg_rss"},
                    f"the superstep cells on linreg_rss: {counts}")
            # the emit-all cell on conv_pmp's N = 7 x depth 3 tree (the
            # general mode; not in pmpx's P grid, which is binary and flat)
            reset_launches()
            gspec = SamplerSpec(algo="pmp", N=7, depth=3, step_size=0.02,
                                selection="all_first")
            res = ess_msjd._emit_all_cell_fused(
                et, gspec, bench.theta0(dev), ESS_STEPS, ESS_BURN, ESS_STEPS,
                f"{tmp}/general", 0, False, "pmp_general_N7_D3")
            counts = {k: v for k, v in launches.items() if v}
            root_e, root_m, all_e, all_m, dt = res
            print(f"general emit-all cell: {dt:.6g} s wall")
            out = {"pmp_general_N7_D3_P512_all_ess_per_s": all_e / dt,
                   "pmp_general_N7_D3_P512_all_msjd_per_s": all_m / dt,
                   "pmp_general_N7_D3_P512_ess_per_s": root_e / dt,
                   "pmp_general_N7_D3_P512_msjd_per_s": root_m / dt}
            ess_runs["general_all"] = {"summary": out, "launches": counts}
            print(json.dumps({"ess_msjd": "general_all", **out,
                              "launches": counts}))
            for k, v in out.items():
                require(math.isfinite(v) and v > 0, f"general: {k} = {v}")
            require(counts == {"fused_chain_general_all":
                               2 * ESS_STEPS // 500},
                    f"the general emit-all cell on fused_chain: {counts}")
        print(json.dumps({
            "ess_msjd_reduced": [
                f"num_steps {ESS_STEPS} with burn-in {ESS_BURN} (the "
                "paper's 1,000,000 and 2,000)",
                f"superstep-path emit-all cells only at P in "
                f"{list(ESS_SWEEP_PS)}, {ESS_SWEEP_STEPS} steps with burn-in "
                f"{ESS_SWEEP_BURN} (host-bound path)",
            ], "n_data": ESS_N}))
        phase9 = {"fused_chain_all": "fused_all",
                  "fused_chain_mp_all": "fused_all",
                  "fused_chain_general_all": "general_all",
                  "fused_chain_farm": "fused_chains8"}
        for k in kernels:
            if k["name"] in phase9:
                k["launches"] = ess_runs[phase9[k["name"]]]["launches"][
                    k["name"]]

    print(json.dumps({
        "bench": "pmp_p1024_n100k", "device": name, "power": smi,
        "sweep_us_per_iter": sweep_us, "fused_us_per_iter": fused_us,
        "a100_reference_us_per_iter": bench.A100_REFERENCE_US,
        "total_wall_s": time.perf_counter() - t_start,
    }))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
