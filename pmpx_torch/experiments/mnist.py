"""MNIST posterior sampling: {FC, CNN, LSTM} x {MH, MP, PMP} (port of
``pmpx/experiments/mnist.py``).

Parity with ``complex_nets/Mnist/{FC,CNN,LSTM}/{MH,MP,PMP}_*.py``:
full-batch cross-entropy posterior, random-walk proposals with
alpha=1e-4, z-score weight standardisation, single-draw selection,
loss/accuracy trace dumps with the reference naming convention.  The reference warm-starts from
SGD-pretrained ``.pkl`` checkpoints; ``pretrain_steps`` of Adam provides
the equivalent warm start, and ``warm_start`` reads such a checkpoint.
``lstm_kernel`` evaluates the LSTM posterior through the CUDA kernel
``csrc/lstm_fused.cu``, one launch per superstep; ``cnn_kernel`` the CNN
posterior through the space-to-depth path of
:mod:`pmpx_torch.kernels.cnn_fast` (cuDNN and cuBLAS calls).  The CNN
runs on the NHWC model unless ``layout="packed"`` (the channel-packed
executor of :mod:`pmpx_torch.models.packed`).

``chunk_steps`` runs the chain as checkpointed chunks
(:func:`pmpx_torch.checkpoint.resume_chain`), the default at
``scale="paper"``; ``resume=True`` continues from the checkpoint, or
adopts a shorter run of the same protocol (``adopt_prefix_run``).  The
chunked chain is bit-equal to the one-loop chain of the same seed.
"""

from __future__ import annotations

import os
import time

import torch

from pmpx_torch._device import resolve_device
from pmpx_torch.config import SamplerSpec
from pmpx_torch.data import load_mnist
from pmpx_torch.metrics.recorder import reference_style_name, save_trace
from pmpx_torch.models import MnistCNN, MnistLSTM, MnistMLP, PackedMnistCNN
from pmpx_torch.samplers.base import compile_chain
from pmpx_torch.targets.nn import NNPosterior

# the model for a layout: only the CNN has another ("packed"), as in pmpx
MODELS = {
    "FC": lambda layout: MnistMLP(),
    "CNN": lambda layout: (
        PackedMnistCNN() if layout == "packed" else MnistCNN()
    ),
    "LSTM": lambda layout: MnistLSTM(),
}
PAPER_STEPS = {"FC": 500000, "CNN": 250000, "LSTM": 1000000}
# scale="paper"'s checkpoint interval: a chunk of a few seconds to a
# minute at the card's full-batch ms per superstep (NVIDIA H100 80GB HBM3,
# 700 W: FC PMP ~13.5 ms, LSTM PMP through lstm_fused ~8 ms, CNN PMP ~200
# ms; PERF.md §5-6), so a crash loses at most a minute of work
PAPER_CHUNK = {"FC": 5000, "CNN": 250, "LSTM": 5000}


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
    """The chain, its first superstep (and the capture) a warm-up outside
    the timed window.  Returns (final state, per-step records, us per
    timed superstep or None): CUDA events on a card, nothing elsewhere."""
    chain = compile_chain(superstep, gen, theta0, collect)
    theta, first = chain.run(gen, theta0, 1)
    if num_steps == 1:
        return theta, first, None
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    theta, rest = chain.run(gen, theta, num_steps - 1)
    us = None
    if dev.type == "cuda":
        end.record()
        end.synchronize()
        us = start.elapsed_time(end) * 1e3 / (num_steps - 1)
    return theta, torch.cat([first, rest]), us


def _chunked_chain(superstep, gen, theta0, num_steps, chunk_steps, resume,
                   collect, out_dir, name, protocol, name_of):
    """The chain as checkpointed chunks under ``out_dir/<name>.ckpt``.
    ``resume`` continues from the checkpoint, or adopts the longest
    shorter run of the same protocol (``name_of(steps)`` gives its stem).
    Returns (final state, the whole loss trace, steady ms a superstep or
    None)."""
    from pmpx_torch.checkpoint import (
        TraceAccumulator, adopt_prefix_run, resume_chain, save_checkpoint,
        write_protocol_sidecar,
    )

    ckpt = os.path.join(out_dir, f"{name}.ckpt")
    if resume and not os.path.exists(ckpt):
        adopted = adopt_prefix_run(out_dir, name_of, num_steps,
                                   keys=("loss",), protocol=protocol)
        if adopted is not None:
            print(f"adopted {adopted}-step prefix run as resume seed")
    fresh = not (resume and os.path.exists(ckpt))
    # per-chunk records on disk: a resumed run (which returns only the
    # chunks it ran) still ends with the whole trace
    acc = TraceAccumulator(out_dir, name, ("loss",), fresh=fresh)
    if fresh:
        save_checkpoint(ckpt, theta0, gen, 0)
        write_protocol_sidecar(out_dir, name, protocol)
    thetaF, _ = resume_chain(superstep, ckpt, num_steps, collect=collect,
                             checkpoint_every=chunk_steps, on_chunk=acc)
    steady = acc.steady_s_per_step(chunk_steps)
    return (thetaF, acc.load("loss"),
            None if steady is None else steady * 1e3)


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
    ``loss_last``, ``train_acc`` and ``test_acc``, and with
    ``chunk_steps`` ``steady_ms_per_superstep`` (the median chunk's wall
    time a superstep, the first chunk left out).  The trace's JSON
    manifest also holds ``us_per_superstep`` (CUDA events around every
    superstep but the first) when a one-loop chain ran on a card."""
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}")
    if lstm_kernel and model != "LSTM":
        raise ValueError("--lstm-kernel requires --model LSTM")
    if cnn_kernel and (model != "CNN" or layout != "nhwc"):
        raise ValueError("--cnn-kernel requires --model CNN (nhwc)")
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
        if chunk_steps is None:
            chunk_steps = PAPER_CHUNK[model]
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
        MODELS[model](layout), x_tr, y_tr, temper=temper, seed=seed,
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

    if cnn_kernel:
        # the space-to-depth CNN forward, on the same contract as
        # lstm_kernel: forward only, attached after pretrain, a protocol
        # field (another rounding of the densities)
        from pmpx_torch.kernels import cnn_fast

        cnn_fast.attach(target)

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
    us = steady_ms = None
    with torch.no_grad():
        if chunk_steps:
            protocol = {
                "temper": float(temper),
                "n_train": int(n_train), "n_test": int(n_test),
                "class_sep": float(class_sep),
                "label_noise": float(label_noise),
                "seed": int(seed),
                "compute_dtype": compute_dtype,
                # a kernel run never splices onto a generic-path prefix
                # (another rounding of the densities)
                **({"lstm_kernel": True} if lstm_kernel else {}),
                **({"cnn_kernel": True} if cnn_kernel else {}),
                "layout": layout,
                "warm_start": warm_start or None,
                "pretrain_steps": None if warm_start else int(pretrain_steps),
            }
            thetaF, losses, steady_ms = _chunked_chain(
                superstep, gen, theta0, num_steps, chunk_steps, resume,
                loss_of, out_dir, name, protocol,
                lambda s: reference_style_name(algo.upper(), alpha, s,
                                               model=model, N=N))
        else:
            thetaF, losses, us = _timed_chain(superstep, gen, theta0,
                                              num_steps, loss_of, dev)
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
    if steady_ms is not None:
        meta["steady_ms_per_superstep"] = steady_ms
    save_trace(out_dir, name, {"loss": losses}, meta)
    out = {
        "loss_first": float(losses[0]),
        "loss_last": float(losses[-1]),
        "train_acc": acc_tr,
        "test_acc": acc_te,
    }
    if steady_ms is not None:
        out["steady_ms_per_superstep"] = steady_ms
    return out
