"""Where a CIFAR-10 LeNet HMC superstep's time and memory go on the card.

``chip_smoke.py`` phase 12b times ``cifar_hmc.run`` at the paper's widths
(50,000 training images) under ``torch.use_deterministic_algorithms``.
This script splits that time: on the same synthetic stand-in and LeNet
posterior, it times (CUDA events, after a warm-up) the posterior's
``value_and_grad_batch`` at P = 1, 2 and 4 networks, a forward pass
(``log_prob``), the collect's two accuracies, and one superstep of each
HMC algorithm (the protocol's N = 7, step 0.1, mom_scale 0.0005), each
with deterministic algorithms on and off, with the peak memory of each;
then one P = 1 gradient without ``vmap`` (``torch.func.grad_and_value``
of the same function), and a ``torch.profiler`` table of the CUDA
kernels of one P = 1 gradient (``pmpx_torch.profiling``).  One JSON line
a measurement.  On a machine with a CUDA card, from the root of the repo:

    python scripts/lenet_grad_profile.py
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pmpx_torch import profiling  # noqa: E402
from pmpx_torch.data import load_cifar10  # noqa: E402
from pmpx_torch.experiments.cifar_hmc import sampler_spec  # noqa: E402
from pmpx_torch.models import LeNet  # noqa: E402
from pmpx_torch.targets.nn import NNPosterior  # noqa: E402

REPS = 5


@contextlib.contextmanager
def determinism(on: bool):
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(on, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=True)


def timed(fn, reps=REPS):
    """(mean ms on the card, peak GiB) of fn() after one warm-up."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return start.elapsed_time(end) / reps, peak / 2**30, (peak - base) / 2**30


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    x_tr, y_tr, x_te, y_te = load_cifar10(50_000, 10_000, device=dev)
    post = NNPosterior(LeNet(), x_tr, y_tr, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    theta = post.init_theta()
    rows = []

    def emit(what, det, ms, peak, extra_gib, **kw):
        rec = {"measure": what, "deterministic": det, "ms": ms,
               "peak_gib": peak, "peak_above_resident_gib": extra_gib,
               **kw, "n_train": 50_000, "device": smi}
        rows.append(rec)
        print(json.dumps(rec), flush=True)

    for det in (False, True):
        with determinism(det), torch.no_grad():
            for P in (1, 2, 4):
                Theta = theta + 1e-3 * torch.randn(
                    (P, post.d), generator=g, device=dev)
                emit(f"value_and_grad_batch P={P}", det,
                     *timed(lambda: post.value_and_grad_batch(Theta)))
            emit("log_prob (a forward)", det,
                 *timed(lambda: post.log_prob(theta)))
            emit("two accuracies (train, test)", det, *timed(
                lambda: (post.accuracy(theta),
                         post.accuracy(theta, x_te, y_te))))
            for algo in ("sp_hmc", "mp_hmc", "pmp_hmc"):
                sup = sampler_spec(algo, 7, 0.1, 0.0005).build(post)
                emit(f"superstep {algo}", det, *timed(
                    lambda: sup(g, theta), reps=3))
    with torch.no_grad():
        gv = torch.func.grad_and_value(post._neg_loss)
        emit("grad_and_value without vmap, P=1", False,
             *timed(lambda: gv(theta)))

    Theta = theta[None]
    with torch.no_grad(), tempfile.TemporaryDirectory() as log_dir:
        post.value_and_grad_batch(Theta)
        with profiling.trace(log_dir):
            post.value_and_grad_batch(Theta)
        kernels = profiling.device_time_us(log_dir)
    table = sorted(((t, k) for k, t in kernels.items()), reverse=True)
    total = sum(kernels.values())
    print(json.dumps({"profile": "value_and_grad_batch P=1",
                      "device_us_total": total,
                      "top": [{"kernel": k[:90], "us": t, "share": t / total}
                              for t, k in table[:15]],
                      "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
