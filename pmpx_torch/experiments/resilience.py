"""Crash resilience end to end: kill a live run, resume, prove bitwise
identity (port of ``pmpx/experiments/resilience.py``).

The reference's only crash story is per-iteration txt streams from the
host loop (``conv_mp.cu:283-289``): a crashed run restarts from zero.
Here a chain killed mid-chunk resumes from its last checkpoint and ends
with a trace bitwise identical to an uninterrupted run's:
:func:`pmpx_torch.checkpoint.resume_chain` saves the chain's generator
state at every chunk boundary and restores it on resume, each chunk's
records stream through the native ``TraceWriter``
(:mod:`pmpx_torch.runtime`), and a re-run chunk overwrites its file with
identical bytes.

The superstep is the binary PMP tree over the linreg posterior on the
sweep path, so on a card every superstep launches ``linreg_rss``.  The
uninterrupted run and the crash-looped one each run in subprocesses on the
same device, so the comparison is between identical programs.  Two
interruption modes:

* ``kill_mode="sigkill"``: the parent SIGKILLs the child mid-chunk (a
  real crash);
* ``kill_mode="exit"``: the child exits cleanly after one chunk
  (preemption at a chunk boundary).
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

CHILD_SRC = r"""
import sys
from pmpx_torch.experiments.resilience import child
child(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]),
      int(sys.argv[6]), int(sys.argv[7]), int(sys.argv[8]),
      int(sys.argv[9]), device=sys.argv[1])
"""

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _build_superstep(n_data: int, depth: int, seed: int, dev):
    import torch

    from pmpx_torch.config import SamplerSpec
    from pmpx_torch.targets.linreg import BayesLinReg, make_synthetic_linreg

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x, y = make_synthetic_linreg(gen, n_data)
    target = BayesLinReg(x, y, temper=1.0 / 2000.0, method="sweep",
                         device=dev)
    spec = SamplerSpec(algo="pmp", N=1, depth=depth, step_size=0.02,
                       selection="all_first")
    return spec.build(target)


def child(
    work_dir: str,
    num_steps: int,
    checkpoint_every: int,
    n_data: int,
    depth: int,
    seed: int,
    max_chunks: int = 0,
    throttle_ms: int = 0,
    device=None,
):
    """Run (or resume) the chain, streaming each chunk's states to
    ``trace_<start>.bin`` through the native ``TraceWriter``.

    ``max_chunks > 0`` bounds this launch to that many chunks and exits
    cleanly (preemption).  ``throttle_ms`` sleeps after each trace write
    and before the checkpoint save: it widens the worst crash window
    (records persisted, progress not yet committed; a resume re-runs the
    chunk and overwrites its file with identical bytes)."""
    import torch

    from pmpx_torch._device import resolve_device
    from pmpx_torch.checkpoint import (
        load_checkpoint, resume_chain, save_checkpoint,
    )
    from pmpx_torch.kernels import launches, reset_launches
    from pmpx_torch.runtime import TraceWriter

    dev = resolve_device(device)
    superstep = _build_superstep(n_data, depth, seed, dev)
    ckpt = os.path.join(work_dir, "chain.ckpt")
    if not os.path.exists(ckpt):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        theta0 = torch.tensor([0.0, 0.0, 1.0], device=dev)
        save_checkpoint(ckpt, theta0, gen, 0)
    if max_chunks > 0:
        _, _, start, _ = load_checkpoint(ckpt)
        num_steps = min(num_steps, start + max_chunks * checkpoint_every)

    def on_chunk(start, recs):
        tw = TraceWriter(os.path.join(work_dir, f"trace_{start:09d}.bin"),
                         recs.shape[1])
        for row in recs:
            tw.append(row)
        tw.close()
        if throttle_ms:
            time.sleep(throttle_ms / 1000.0)

    reset_launches()
    with torch.no_grad():
        resume_chain(superstep, ckpt, num_steps,
                     collect=lambda th, out: th,
                     checkpoint_every=checkpoint_every, on_chunk=on_chunk)
    # this launch's kernel launches (a killed launch writes none)
    with open(os.path.join(work_dir, "launches.json"), "w") as f:
        json.dump({k: v for k, v in launches.items() if v}, f)


def _spawn(work_dir, num_steps, every, n_data, depth, seed, throttle_ms,
           device, max_chunks=0):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    # the child's errors go to a file: a pipe nobody reads while the
    # parent polls the checkpoint could fill and stall the child
    with open(os.path.join(work_dir, "child.log"), "ab") as log:
        return subprocess.Popen(
            [sys.executable, "-c", CHILD_SRC, device, work_dir,
             str(num_steps), str(every), str(n_data), str(depth), str(seed),
             str(max_chunks), str(throttle_ms)],
            env=env, stdout=subprocess.DEVNULL, stderr=log,
        )


def _wait(p, work_dir: str, what: str) -> None:
    if p.wait() != 0:
        with open(os.path.join(work_dir, "child.log"), "rb") as f:
            tail = f.read().decode(errors="replace")[-2000:]
        raise RuntimeError(f"{what} failed rc={p.returncode}:\n{tail}")


def _ckpt_step(work_dir) -> int:
    path = os.path.join(work_dir, "chain.ckpt")
    if not os.path.exists(path):
        return -1
    try:
        with open(path, "rb") as f:
            return int(np.load(f)["step"])
    except Exception:
        return -1  # replaced between the check and the read


def _launches(work_dir) -> dict:
    path = os.path.join(work_dir, "launches.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _assemble(work_dir) -> np.ndarray:
    from pmpx_torch.runtime import read_trace

    files = sorted(glob.glob(os.path.join(work_dir, "trace_*.bin")))
    return np.concatenate([read_trace(f) for f in files], axis=0)


def run(
    num_steps: int = 3000,
    checkpoint_every: int = 500,
    kills: int = 2,
    n_data: int = 2000,
    depth: int = 5,
    seed: int = 0,
    throttle_ms: int = 0,
    kill_mode: str = "sigkill",  # sigkill | exit
    out_dir: str = "results/resilience",
    scale: str = "smoke",
    device=None,
):
    """Run one uninterrupted child and one crash-looped chain of children
    (``kills`` interruptions), assemble both traces and require them
    bitwise identical.  Returns the summary (also ``summary.json``)."""
    from pmpx_torch._device import resolve_device

    dev = str(resolve_device(device))
    if kill_mode not in ("sigkill", "exit"):
        raise ValueError(f"unknown kill_mode {kill_mode!r}")
    if scale == "paper":
        num_steps, checkpoint_every, n_data, kills = (
            1_000_000, 100_000, 100_000, 3)
    os.makedirs(out_dir, exist_ok=True)
    ref_dir = os.path.join(out_dir, "uninterrupted")
    cut_dir = os.path.join(out_dir, "killed")
    for d in (ref_dir, cut_dir):
        os.makedirs(d, exist_ok=True)
        for f in glob.glob(os.path.join(d, "*")):
            os.remove(f)

    args = (num_steps, checkpoint_every, n_data, depth, seed, throttle_ms)

    # reference: one uninterrupted child
    t0 = time.perf_counter()
    _wait(_spawn(ref_dir, *args, dev), ref_dir, "uninterrupted child")
    ref_wall = time.perf_counter() - t0

    # crash loop: kill mid-chunk (sigkill) or preempt at chunk boundaries
    # (exit), resuming until the chain completes
    kill_log = []
    done_kills = 0
    launches = 0
    t0 = time.perf_counter()
    while _ckpt_step(cut_dir) < num_steps:
        launches += 1
        if done_kills < kills and kill_mode == "exit":
            _wait(_spawn(cut_dir, *args, dev, max_chunks=1), cut_dir,
                  "bounded child")
            done_kills += 1
            kill_log.append({"launch": launches,
                             "clean_exit_at_step": _ckpt_step(cut_dir)})
            continue
        p = _spawn(cut_dir, *args, dev)
        if done_kills < kills:
            # wait for progress beyond the current checkpoint, then
            # SIGKILL inside the next chunk (a real crash)
            base = max(_ckpt_step(cut_dir), 0)
            deadline = time.time() + 300
            while (_ckpt_step(cut_dir) <= base and p.poll() is None
                   and time.time() < deadline):
                time.sleep(0.02)
            if p.poll() is None:
                time.sleep(0.05)  # land inside the next chunk
                p.kill()
                p.wait()
                at = _ckpt_step(cut_dir)
                if at < num_steps:  # a genuine mid-run crash
                    done_kills += 1
                    kill_log.append({"launch": launches,
                                     "sigkill_at_step": at})
                continue
        _wait(p, cut_dir, "resumed child")
    cut_wall = time.perf_counter() - t0

    ref = _assemble(ref_dir)
    cut = _assemble(cut_dir)
    identical = ref.shape == cut.shape and bool(np.array_equal(ref, cut))
    summary = {
        "num_steps": num_steps,
        "checkpoint_every": checkpoint_every,
        "n_data": n_data,
        "depth": depth,
        "device": dev,
        "kill_mode": kill_mode,
        "kills": done_kills,
        "launches": launches,
        "kill_log": kill_log,
        "rows": int(cut.shape[0]),
        "uninterrupted_wall_s": ref_wall,
        "crash_loop_wall_s": cut_wall,
        "bitwise_identical": identical,
        "uninterrupted_launches": _launches(ref_dir),
    }
    with open(os.path.join(out_dir, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    if not identical:
        raise AssertionError(
            f"resumed trace differs from uninterrupted run: {summary}")
    return summary
