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
   the grid's own data;
4. the sweep main path of the benchmark cell (``pmpx_torch.bench``), with
   its launch count and a posterior check;
5. the fused main path, likewise;
6. each kernel's time beside its plain version's and its bound (the
   launches of each from the time grid of phase 7);
7. the time grid of the reference (``pmpx_torch.experiments.
   time_analysis``) at full width on both paths, with a posterior check of
   a flat-MP and a general fused chain;
8. ``cores_sweep`` on the fused path for PMP and MP, its wall budget cut
   to ``CORES_SET_TIME`` seconds per P (the one reduction).

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
# and P = 8 at other sizes
RSS_SHAPES = ((1024, 100_000), (1024, 500), (4, 100_000), (4, 500),
              (200, 100_000), (8, 5000))
# phase 3c: (N, depth) of the time grid's fused cells: PMP P = 4 (depth 2,
# lanes above P) and P = 1024, MP P = 4 and P = 1024, conv_pmp's N = 7 x 3
GRID_FUSED = ((1, 2), (1, 10), (3, 1), (1023, 1), (7, 3))
POSTERIOR_STEPS = 50_000  # phase 7's flat-MP and general posterior chains
POSTERIOR_BURN = 10_000
# phase 8: the wall budget per P (pmpx's default is 5 s, the paper's 180)
CORES_SET_TIME = 2.0


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


def event_ms(fn, reps: int) -> float:
    """Mean ms of fn() on the card over ``reps`` calls, after one warm-up."""
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
    from pmpx_torch.experiments import time_analysis
    from pmpx_torch.kernels import fused_chain as fc
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

    with Phase("3c the time grid's fused cells vs plain"):
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
            grid_counts.update({k: v for k, v in launches.items()
                                if k.startswith("fused_chain")})
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
