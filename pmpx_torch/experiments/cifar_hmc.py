"""CIFAR-10 LeNet posterior via the HMC-flavoured samplers (port of
``pmpx/experiments/cifar_hmc.py``).

Parity with ``complex_nets/Cifar-10/cifar_{SP,MP,PMP}hmc.py``: full-batch
cross-entropy posterior over LeNet, momentum scale 0.0005, leapfrog step
0.1, N = 7 (PMP a binary tree of depth 3), loss, train accuracy and test
accuracy recorded every superstep and saved per run.  ``layout="packed"``
runs the channel-packed LeNet (:mod:`pmpx_torch.models.packed`, the same
parameters; ``remat`` is then the packed convolutions' own, on).
"""

from __future__ import annotations

import os

import torch

from pmpx_torch._device import resolve_device
from pmpx_torch.config import SamplerSpec
from pmpx_torch.data import load_cifar10
from pmpx_torch.experiments.mnist import pretrain
from pmpx_torch.metrics.recorder import save_trace
from pmpx_torch.models import LeNet, PackedLeNet
from pmpx_torch.samplers.base import run_chain
from pmpx_torch.targets.nn import NNPosterior

# scale="paper"'s checkpoint interval, sized for the card: about a minute
# of supersteps at the full-batch times measured on an NVIDIA H100 80GB
# HBM3 at 700 W (scripts/lenet_grad_profile.py: SP ~191 ms, MP ~953, PMP
# ~566 a superstep, ~45 ms more of collect; PERF.md §6), so a crash loses
# at most about a minute of work
PAPER_CHUNK = {"sp_hmc": 250, "pmp_hmc": 100, "mp_hmc": 60}


def sampler_spec(algo: str, N: int, step_size: float,
                 mom_scale: float) -> SamplerSpec:
    """The CIFAR zoo's sampler configuration (cifar_{SP,MP,PMP}hmc.py
    protocol).  The reference's "N" means N+1 speculative states in a
    binary tree (``SamplerSpec.reference_nn``)."""
    return SamplerSpec.reference_nn(
        algo, N,
        step_size=step_size,
        mom_scale=mom_scale,
        rule="mh_clamp" if algo == "pmp_hmc" else None,
        accept_scale=1000.0 if algo == "sp_hmc" else 1.0,
    )


def run(
    algo: str = "pmp_hmc",  # sp_hmc | mp_hmc | pmp_hmc
    N: int = 7,
    step_size: float = 0.1,
    mom_scale: float = 0.0005,
    num_steps=None,
    n_train=None,
    n_test=None,
    pretrain_steps: int = 30,
    seed: int = 0,
    out_dir: str = "results/cifar",
    scale: str = "smoke",
    warm_start: str = "",
    class_sep: float = 1.5,
    label_noise: float = 0.0,
    layout: str = "nhwc",
    remat: bool = False,
    proposal_chunk=None,
    compute_dtype: str = "",
    chunk_steps=None,
    resume: bool = False,
    device=None,
):
    """``scale="paper"`` is the reference's protocol: full-batch 50,000
    train / 10,000 test images, 50,000 supersteps, loss, train and test
    accuracy every superstep (``cifar_PMPhmc.py:164-170``), in checkpointed
    chunks (``chunk_steps``, per algorithm by default; ``resume=True``
    continues from the checkpoint).  Returns ``loss_first``, ``loss_last``,
    ``test_acc_last`` and, with chunks, ``steady_ms_per_superstep`` (the
    median chunk's wall time a superstep, the first chunk left out)."""
    if algo not in PAPER_CHUNK:
        raise ValueError(f"unknown algo {algo!r}")
    dev = resolve_device(device)
    if scale == "paper":
        n_train = 50000 if n_train is None else n_train
        n_test = 10000 if n_test is None else n_test
        if num_steps is None:
            num_steps = 50000
        if chunk_steps is None:
            chunk_steps = PAPER_CHUNK[algo]
    else:
        n_train = 2048 if n_train is None else n_train
        n_test = 512 if n_test is None else n_test
        if num_steps is None:
            num_steps = 10
    x_tr, y_tr, x_te, y_te = load_cifar10(
        n_train=n_train, n_test=n_test, class_sep=class_sep,
        label_noise=label_noise, device=dev,
    )
    target = NNPosterior(
        PackedLeNet() if layout == "packed" else LeNet(remat=remat),
        x_tr, y_tr, seed=seed,
        proposal_chunk=proposal_chunk, device=dev,
        compute_dtype=torch.bfloat16 if compute_dtype == "bf16" else None,
    )
    if warm_start:
        # seed from a torch checkpoint, e.g. the reference's cifar.pkl
        # LeNet warm start (cifar_PMPhmc.py:175-176)
        from pmpx_torch.interop import (
            load_torch_pickle, theta_from_torch_state,
        )

        theta0 = theta_from_torch_state(target, load_torch_pickle(warm_start))
    else:
        theta0 = pretrain(target, pretrain_steps)

    superstep = sampler_spec(algo, N, step_size, mom_scale).build(target)
    name = f"cifar_{algo}"
    meta = {"N": N, "num_steps": num_steps}

    def collect(theta, out):
        return (-target.log_prob(theta), target.accuracy(theta),
                target.accuracy(theta, x_te, y_te))

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
                                   ("loss", "train_acc", "test_acc"),
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
            _, (losses, acc_tr, acc_te) = run_chain(
                superstep, gen, theta0, num_steps, collect=collect)
            arrays = {"loss": losses.cpu().numpy(),
                      "train_acc": acc_tr.cpu().numpy(),
                      "test_acc": acc_te.cpu().numpy()}
    save_trace(out_dir, name, arrays, meta)
    out = {
        "loss_first": float(arrays["loss"][0]),
        "loss_last": float(arrays["loss"][-1]),
        "test_acc_last": float(arrays["test_acc"][-1]),
    }
    if "steady_ms_per_superstep" in meta:
        out["steady_ms_per_superstep"] = meta["steady_ms_per_superstep"]
    return out
