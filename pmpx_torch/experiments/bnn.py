"""Mean-field BNN posterior sampling via PMP-HMC, the reference's flagship
(port of ``pmpx/experiments/bnn.py``).

Parity with ``Bayesian Network Training/main.py``: a torchbnn-style
BayesLinear MLP 784-1024-10 over full-batch MNIST, PMP-HMC with the
clamped-Barker tree rule (``main.py:84-99``), N = 2**n - 1 through the
``n`` argument (the reference's ``--N``), 30,000 steps at paper scale, the
trajectory of the first 10 parameters recorded (``main.py:169-171``).
``algo="sp_hmc"`` is the single-proposal baseline.
"""

from __future__ import annotations

import os

import torch

from pmpx_torch import tree
from pmpx_torch._device import resolve_device
from pmpx_torch.config import SamplerSpec
from pmpx_torch.data import load_mnist
from pmpx_torch.metrics.recorder import save_trace
from pmpx_torch.models import BayesMLP
from pmpx_torch.samplers.base import run_chain
from pmpx_torch.targets.nn import NNPosterior


def _fixed(dev, seed: int) -> torch.Generator:
    """A fresh generator at a fixed seed: the collect's fixed-noise
    evaluations (``pmpx`` uses ``jax.random.key(123)`` and ``key(124)``)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def run(
    n: int = 2,  # the reference's --N: parallelism 2**n - 1
    algo: str = "pmp_hmc",  # | "sp_hmc" (the notebook's A100 baseline)
    hidden: int = 1024,
    step_size: float = 0.1,
    mom_scale: float = 0.0005,
    num_steps=None,
    n_train=None,
    n_test=None,
    seed: int = 0,
    out_dir: str = "results/bnn",
    scale: str = "smoke",
    label_noise: float = 0.0,
    class_sep: float = 1.5,
    chunk_steps=None,
    resume: bool = False,
    device=None,
):
    """``scale="paper"`` is the full 30,000-step protocol (``main.py:
    179-190``) over 60,000 / 10,000 images, in checkpointed chunks of 1000
    (``resume=True`` continues from the checkpoint).  Returns ``N``,
    ``algo``, ``loss_first``, ``loss_last``, ``acc_last`` and, with chunks,
    ``steady_ms_per_superstep``."""
    if algo not in ("pmp_hmc", "sp_hmc"):
        raise ValueError(f"unknown algo {algo!r}")
    dev = resolve_device(device)
    if scale == "paper":
        n_train = 60000 if n_train is None else n_train
        n_test = 10000 if n_test is None else n_test
        if num_steps is None:
            num_steps = 30000
        if chunk_steps is None:
            chunk_steps = 1000
    else:
        n_train = 4096 if n_train is None else n_train
        n_test = 1024 if n_test is None else n_test
        if num_steps is None:
            num_steps = 30
    N = 2**n - 1
    depth = max(tree.binary_depth(N + 1), 1)
    x_tr, y_tr, _, _ = load_mnist(
        n_train=n_train, n_test=n_test, class_sep=class_sep,
        label_noise=label_noise, device=dev,
    )
    target = NNPosterior(BayesMLP(hidden=hidden), x_tr, y_tr, seed=seed,
                         stochastic=True, device=dev)
    theta0 = target.init_theta()
    if algo == "sp_hmc":
        spec = SamplerSpec(algo="sp_hmc", step_size=step_size,
                           mom_scale=mom_scale)
        name = "bnn_sphmc"
    else:
        spec = SamplerSpec(algo="pmp_hmc", depth=depth, step_size=step_size,
                           mom_scale=mom_scale, rule="barker_clamp")
        name = f"bnn_pmphmc_N{N}"
    superstep = spec.build(target)

    # the reference records loss, accuracy and the first 10 parameters
    # (main.py:169-171, 187-190), each evaluation on fixed noise: drawn
    # once here, as a generator seeded inside the step would draw it (a
    # captured step replays only the draws of the chain's generator)
    loss_noise = target.draw_noise(_fixed(dev, 123))
    acc_noise = target.draw_noise(_fixed(dev, 124))

    def collect(theta, out):
        loss = -target.log_prob(theta, noise=loss_noise)
        acc = target.accuracy(theta, noise=acc_noise)
        return loss, acc, theta[:10]

    meta = {"N": N, "algo": algo, "num_steps": num_steps}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    with torch.no_grad():
        if chunk_steps:
            from pmpx_torch.checkpoint import (
                TraceAccumulator, resume_chain, save_checkpoint,
            )

            ckpt = os.path.join(out_dir, f"{name}.ckpt")
            fresh = not (resume and os.path.exists(ckpt))
            acc = TraceAccumulator(out_dir, name,
                                   ("loss", "acc", "trajectory10"),
                                   fresh=fresh)
            if fresh:
                save_checkpoint(ckpt, theta0, gen, 0)
            resume_chain(superstep, ckpt, num_steps, collect=collect,
                         checkpoint_every=chunk_steps, on_chunk=acc)
            arrays = {k: acc.load(k) for k in acc.keys}
            steady = acc.steady_s_per_step(chunk_steps)
            if steady is not None:
                meta["steady_ms_per_superstep"] = steady * 1e3
        else:
            _, (losses, accs, traj) = run_chain(superstep, gen, theta0,
                                                num_steps, collect=collect)
            arrays = {"loss": losses.cpu().numpy(),
                      "acc": accs.cpu().numpy(),
                      "trajectory10": traj.cpu().numpy()}
    save_trace(out_dir, name, arrays, meta)
    out = {
        "N": N,
        "algo": algo,
        "loss_first": float(arrays["loss"][0]),
        "loss_last": float(arrays["loss"][-1]),
        "acc_last": float(arrays["acc"][-1]),
    }
    if "steady_ms_per_superstep" in meta:
        out["steady_ms_per_superstep"] = meta["steady_ms_per_superstep"]
    return out
