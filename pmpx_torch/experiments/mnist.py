"""MNIST posterior sampling: {FC, LSTM} x {MH, MP, PMP} (port of
``pmpx/experiments/mnist.py``).

Parity with ``complex_nets/Mnist/{FC,LSTM}/{MH,MP,PMP}_*.py``: full-batch
cross-entropy posterior, random-walk proposals with alpha=1e-4, z-score
weight standardisation, single-draw selection, loss/accuracy trace dumps
with the reference naming convention.  The reference warm-starts from
SGD-pretrained ``.pkl`` checkpoints; ``pretrain_steps`` of Adam provides
the equivalent warm start, and ``warm_start`` reads such a checkpoint.
``lstm_kernel`` evaluates the LSTM posterior through the CUDA kernel
``csrc/lstm_fused.cu``, one launch per superstep.

Departures from ``pmpx``: the CNN (and its ``layout``/``cnn_kernel``
options) waits for ROADMAP §1 item 17, and the checkpointed chunks
(``chunk_steps``, ``resume``) for item 12: they raise
``NotImplementedError``.  So ``scale="paper"`` runs the chain as one loop
where ``pmpx`` cuts it into checkpointed chunks (``pmpx``'s own tests show
that both give the same chain).
"""

from __future__ import annotations

import time

import torch

from pmpx_torch._device import resolve_device
from pmpx_torch.config import SamplerSpec
from pmpx_torch.data import load_mnist
from pmpx_torch.metrics.recorder import reference_style_name, save_trace
from pmpx_torch.models import MnistLSTM, MnistMLP
from pmpx_torch.samplers.base import run_chain
from pmpx_torch.targets.nn import NNPosterior

MODELS = {
    "FC": MnistMLP,
    "LSTM": MnistLSTM,
}
PAPER_STEPS = {"FC": 500000, "CNN": 250000, "LSTM": 1000000}


def sampler_spec(algo: str, alpha: float, N: int) -> SamplerSpec:
    """The MNIST zoo's sampler configuration ({MH,MP,PMP}_*.py protocol:
    alpha random walk, single-draw selection, z-score stabilisation)."""
    if algo == "mh":
        return SamplerSpec(algo="mh", step_size=alpha)
    # reference convention: N means N+1 states in a binary tree
    return SamplerSpec.reference_nn(
        algo, N, step_size=alpha, selection="single", stabilizer="zscore",
    )


def pretrain(target: NNPosterior, steps: int, lr: float = 1e-3):
    """Adam warm start (stand-in for the reference's pretrained .pkl), by
    autograd through the generic path on ``-log_prob``."""
    theta = target.init_theta()
    if steps <= 0:
        return theta
    theta = theta.clone().requires_grad_(True)
    opt = torch.optim.Adam([theta], lr=lr)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        (-target.log_prob(theta)).backward()
        opt.step()
    return theta.detach()


def _timed_chain(superstep, gen, theta0, num_steps, collect, dev):
    """The chain, its first superstep a warm-up outside the timed window.
    Returns (final state, per-step records, us per timed superstep or
    None): CUDA events on a card, nothing elsewhere."""
    theta, first = run_chain(superstep, gen, theta0, 1, collect=collect)
    if num_steps == 1:
        return theta, first, None
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    theta, rest = run_chain(superstep, gen, theta, num_steps - 1,
                            collect=collect)
    us = None
    if dev.type == "cuda":
        end.record()
        end.synchronize()
        us = start.elapsed_time(end) * 1e3 / (num_steps - 1)
    return theta, torch.cat([first, rest]), us


def run(
    model: str = "FC",
    algo: str = "pmp",
    alpha: float = 1e-4,
    N: int = 7,
    num_steps=None,
    n_train=None,
    n_test=None,
    pretrain_steps: int = 50,
    temper=None,
    seed: int = 0,
    out_dir: str = "results/mnist",
    scale: str = "smoke",
    class_sep: float = 1.5,
    label_noise: float = 0.0,
    proposal_chunk=None,
    warm_start: str = "",
    layout: str = "nhwc",
    compute_dtype: str = "",
    chunk_steps=None,
    resume: bool = False,
    lstm_kernel: bool = False,
    cnn_kernel: bool = False,
    device=None,
):
    """Run one MNIST posterior chain; returns ``loss_first``,
    ``loss_last``, ``train_acc`` and ``test_acc``.  The trace's JSON
    manifest also holds ``us_per_superstep`` (CUDA events around every
    superstep but the first) when the chain ran on a card."""
    if model == "CNN" or layout != "nhwc" or cnn_kernel:
        raise NotImplementedError(
            "the MNIST CNN (layout, cnn_kernel) is not ported yet "
            "(ROADMAP §1 item 17)")
    if chunk_steps or resume:
        raise NotImplementedError(
            "checkpointed chunks and resume are not ported yet "
            "(ROADMAP §1 item 12)")
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}")
    if lstm_kernel and model != "LSTM":
        raise ValueError("--lstm-kernel requires --model LSTM")
    dev = resolve_device(device)
    if temper is None:
        # the reference tempers MH at an effective log pi = -1000*CE
        # (MH_FC.py:81,99) and MP/PMP at 10 (pmpx's value; the z-score
        # makes the final selection logits scale-invariant)
        temper = 1000.0 if algo == "mh" else 10.0
    if scale == "paper":
        n_train = 60000 if n_train is None else n_train
        n_test = 10000 if n_test is None else n_test
        if num_steps is None:
            num_steps = PAPER_STEPS[model]
    else:
        n_train = 4096 if n_train is None else n_train
        n_test = 1024 if n_test is None else n_test
        if num_steps is None:
            num_steps = 300
    x_tr, y_tr, x_te, y_te = load_mnist(
        n_train=n_train, n_test=n_test, class_sep=class_sep,
        label_noise=label_noise, device=dev,
    )
    target = NNPosterior(
        MODELS[model](), x_tr, y_tr, temper=temper, seed=seed,
        proposal_chunk=proposal_chunk, device=dev,
        compute_dtype=torch.bfloat16 if compute_dtype == "bf16" else None,
    )
    if warm_start:
        # seed from a torch checkpoint, e.g. the reference's own
        # LSTM_model.pkl (PMP_LSTM.py)
        from pmpx_torch.interop import (
            load_torch_pickle, theta_from_torch_state,
        )

        theta0 = theta_from_torch_state(target, load_torch_pickle(warm_start))
    else:
        theta0 = pretrain(target, pretrain_steps)

    if lstm_kernel:
        # attached after pretrain, which differentiates log_prob through
        # the generic path; the kernel is forward-only and the MTM
        # supersteps are gradient-free
        from pmpx_torch.kernels import lstm_fused

        lstm_fused.attach(target)

    superstep = sampler_spec(algo, alpha, N).build(target)
    # CE loss of the chosen state, from the superstep's own density
    # evaluation (no re-evaluation of the full batch per step)
    loss_of = lambda th, o: -o["root_logp"] / target.temper  # noqa: E731

    name = reference_style_name(
        algo.upper(), alpha, num_steps, model=model, N=N
    )
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    t0 = time.perf_counter()
    with torch.no_grad():
        thetaF, losses, us = _timed_chain(superstep, gen, theta0, num_steps,
                                          loss_of, dev)
        losses = losses.cpu().numpy()
        wall_s = time.perf_counter() - t0
        acc_tr = float(target.accuracy(thetaF, x_tr, y_tr))
        acc_te = float(target.accuracy(thetaF, x_te, y_te))
    meta = {
        "model": model,
        "train_acc": acc_tr,
        "test_acc": acc_te,
        "num_steps": num_steps,
        "chain_wall_s": wall_s,
    }
    if us is not None:
        meta["us_per_superstep"] = us
        meta["device"] = torch.cuda.get_device_name(dev)
    save_trace(out_dir, name, {"loss": losses}, meta)
    return {
        "loss_first": float(losses[0]),
        "loss_last": float(losses[-1]),
        "train_acc": acc_tr,
        "test_acc": acc_te,
    }
