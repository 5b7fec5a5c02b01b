"""NN-zoo performance table, the packed layouts' memory, bf16 studies
(port of ``pmpx/experiments/nn_perf.py``).

Measurements the reference never makes but whose workloads it defines:

* ``footprint``: the peak memory on the card of the batched LeNet
  gradient across layouts (NHWC, channel-packed) and memory levers
  (conv-block remat, bf16 activations, proposal chunks), the numbers that
  decide whether full-batch image posteriors (``cifar_PMPhmc.py``'s
  50,000 CIFAR images) fit one card and at what proposal parallelism.
  ``pmpx`` reads its compiler's memory analysis without running; torch
  has no such analysis, so each variant runs once and reads
  ``torch.cuda.max_memory_allocated`` (a variant that runs out of memory
  is recorded as ``{"oom": true, ...}``).  It needs a card.
* ``table``: µs per superstep for every NN-zoo cell at the reference's
  batch sizes: MNIST {FC, CNN, LSTM} x {MH, MP, PMP}
  (``complex_nets/Mnist``; the CNN also packed) and CIFAR LeNet {SP, MP,
  PMP}-HMC (``complex_nets/Cifar-10``; nhwc and packed), through
  :func:`pmpx_torch.profiling.superstep_timer` (CUDA events on a card).
* ``bf16_delta`` and ``bf16_chain``: what bf16 compute does to one
  superstep's acceptance, and to a whole chain's statistics.

The timed supersteps are the zoo experiments' own (``mnist.sampler_spec``,
``cifar_hmc.sampler_spec``).  Every entry point takes ``device`` (CUDA
unless given).
"""

from __future__ import annotations

import json
import os
import re
from fnmatch import fnmatch

import numpy as np
import torch

from pmpx_torch._device import resolve_device
from pmpx_torch.config import SamplerSpec
from pmpx_torch.data import load_cifar10, load_mnist
# the benchmarked supersteps are the zoo experiments' own: one spec
# builder per zoo
from pmpx_torch.experiments.cifar_hmc import sampler_spec as _cifar_spec
from pmpx_torch.experiments.mnist import MODELS as MNIST_MODELS
from pmpx_torch.experiments.mnist import pretrain
from pmpx_torch.experiments.mnist import sampler_spec as _mnist_spec
from pmpx_torch.models import LeNet, PackedLeNet
from pmpx_torch.profiling import superstep_timer
from pmpx_torch.samplers.base import compile_chain
from pmpx_torch.targets.nn import NNPosterior


def _patterns(only) -> list:
    """``only`` as fnmatch patterns: a comma string from Python callers,
    a tuple from the CLI (whose value parser splits on commas)."""
    if isinstance(only, str):
        only = only.split(",")
    return [p for p in (only or ()) if p]


def _wanted(pats: list, names) -> bool:
    return not pats or any(fnmatch(n, p) for n in names for p in pats)


def _free(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def _lenet_target(layout: str, x, y, proposal_chunk=None, remat=False,
                  compute_dtype=None, device=None):
    model = LeNet(remat=remat) if layout == "nhwc" else PackedLeNet()
    return NNPosterior(model, x, y, seed=0, proposal_chunk=proposal_chunk,
                       compute_dtype=compute_dtype, device=device)


def _peak(target, P: int) -> dict:
    """Run ``target.value_and_grad_batch`` once on P states and read the
    card's peak memory (GiB): ``peak_gib`` all told, ``resident_gib``
    before the call (the dataset and what else lives on the card)."""
    dev = target.device
    Theta = target.init_theta().expand(P, -1).clone()
    _free(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    out = {"resident_gib": resident / 2**30}
    try:
        with torch.no_grad():
            target.value_and_grad_batch(Theta)
        torch.cuda.synchronize(dev)
    except torch.cuda.OutOfMemoryError as e:
        msg = str(e)
        out.update(oom=True, error=msg[:300],
                   peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
        m = re.search(r"Tried to allocate ([\d.]+) ([GM]iB)", msg)
        if m:
            out["tried_to_allocate_gib"] = float(m.group(1)) / (
                1024 if m.group(2) == "MiB" else 1)
        del Theta
        _free(dev)
        return out
    peak = torch.cuda.max_memory_allocated(dev)
    out.update(peak_gib=peak / 2**30,
               peak_above_resident_gib=(peak - resident) / 2**30)
    return out


def footprint(P: int = 8, n_train: int = 50000, class_sep: float = 1.5,
              device=None):
    """Peak memory of the P-proposal LeNet gradient over ``n_train``
    CIFAR images, by layout and memory lever, plus a quarter-size pair of
    the two layouts.  Runs each variant on the card; raises elsewhere."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(
            "footprint reads the peak memory of each variant's run on a "
            "CUDA card (torch.cuda.max_memory_allocated); torch has no "
            "compile-only memory analysis, so it does not run on "
            f"{dev.type!r}")
    x, y, _, _ = load_cifar10(n_train=n_train, n_test=8,
                              class_sep=class_sep, device=dev)
    out = {"P": P, "n_train": n_train, "backend": dev.type,
           "device": torch.cuda.get_device_name(dev)}
    variants = {
        "nhwc": {},
        "packed": {},
        # the levers that decide how many full-batch conv gradients fit
        # at once: block remat and bf16 activations (f32 loss/gradients)
        "nhwc_remat": {"remat": True},
        "nhwc_bf16": {"compute_dtype": torch.bfloat16},
        "nhwc_remat_bf16": {"remat": True, "compute_dtype": torch.bfloat16},
    }
    for name, kw in variants.items():
        layout = "packed" if name == "packed" else "nhwc"
        t = _lenet_target(layout, x, y, device=dev, **kw)
        out[f"lenet_grad_{name}"] = _peak(t, P)
        del t
    # the configurations that run long chains: one proposal at a time
    for layout in ("nhwc", "packed"):
        t = _lenet_target(layout, x, y, proposal_chunk=1, device=dev)
        out[f"lenet_grad_{layout}_chunk1"] = _peak(t, P)
        del t
    a = out["lenet_grad_nhwc"].get("peak_gib")
    b = out["lenet_grad_packed"].get("peak_gib")
    if a and b and not out["lenet_grad_packed"].get("oom"):
        out["nhwc_over_packed"] = round(a / b, 2)
    n4 = max(n_train // 4, 64)
    out["quarter"] = {"n_train": n4}
    for layout in ("nhwc", "packed"):
        t = _lenet_target(layout, x[:n4], y[:n4], device=dev)
        out["quarter"][f"lenet_grad_{layout}"] = _peak(t, P)
        del t
    q = out["quarter"]
    a = q["lenet_grad_nhwc"].get("peak_gib")
    b = q["lenet_grad_packed"].get("peak_gib")
    if a and b and not q["lenet_grad_packed"].get("oom"):
        q["nhwc_over_packed"] = round(a / b, 2)
    return out


def _time_cell(target, spec: SamplerSpec, iters: int) -> float:
    """µs per superstep of an ``iters``-superstep chain from the
    target's initial theta (a warm-up chain first: the capture)."""
    gen = torch.Generator(device=target.device)
    gen.manual_seed(1)
    theta0 = target.init_theta()
    chain = compile_chain(spec.build(target), gen, theta0)

    def run(theta):
        with torch.no_grad():
            return chain.run(gen, theta, iters)[0]

    return superstep_timer(run, theta0, iters=iters)


def table(
    iters: int = 20,
    N: int = 7,
    alpha: float = 1e-4,
    n_mnist: int = 60000,
    n_cifar: int = 50000,
    proposal_chunk=None,
    cnn_chunk=2,
    cifar_chunk=1,
    class_sep: float = 1.5,
    only=None,
    on_cell=None,
    device=None,
):
    """µs per superstep for each NN-zoo cell at the reference's batch
    sizes.  Conv cells bound the proposals evaluated at once
    (``cnn_chunk``, ``cifar_chunk``; ``proposal_chunk`` overrides both).

    ``only``: fnmatch patterns over cell names (a comma string or a
    tuple); other cells are skipped.  ``on_cell(name, value)`` is called
    after each cell (incremental persistence).  A cell that fails is
    recorded as ``"error: ..."`` and the table goes on.
    """
    dev = resolve_device(device)
    cells = {}
    pats = _patterns(only)

    def _cell(name, make_target, spec):
        if not _wanted(pats, [name]):
            return
        try:
            cells[name] = round(_time_cell(make_target(), spec, iters), 1)
        except Exception as e:  # record the failure, keep measuring
            cells[name] = f"error: {str(e)[:200]}"
        _free(dev)
        if on_cell is not None:
            on_cell(name, cells[name])

    mnist_names = [f"mnist_{m}_{a}{s}" for m, s in (
        ("FC", ""), ("CNN", ""), ("CNN", "_packed"), ("LSTM", ""))
        for a in ("mh", "mp", "pmp")]
    if _wanted(pats, mnist_names):
        x, y, _, _ = load_mnist(n_train=n_mnist, n_test=8,
                                class_sep=class_sep, device=dev)
        for model in ("FC", "CNN", "LSTM"):
            chunk = proposal_chunk or (cnn_chunk if model == "CNN" else None)
            # nhwc is the default (suffix-free); the packed cells give
            # the alternative's cost
            layouts = ("nhwc", "packed") if model == "CNN" else ("nhwc",)
            for layout in layouts:
                mk = lambda m=model, lo=layout, c=chunk: NNPosterior(  # noqa: E731
                    MNIST_MODELS[m](lo), x, y, temper=10.0, seed=0,
                    proposal_chunk=c, device=dev,
                )
                suffix = "" if layout == "nhwc" else "_packed"
                for algo in ("mh", "mp", "pmp"):
                    _cell(f"mnist_{model}_{algo}{suffix}", mk,
                          _mnist_spec(algo, alpha, N))
        del x, y
    cifar_names = [f"cifar_{a}{s}" for a in ("sp_hmc", "mp_hmc", "pmp_hmc")
                   for s in ("", "_packed")]
    if _wanted(pats, cifar_names):
        xc, yc, _, _ = load_cifar10(n_train=n_cifar, n_test=8,
                                    class_sep=class_sep, device=dev)
        for layout in ("nhwc", "packed"):
            mk = lambda lo=layout: _lenet_target(  # noqa: E731
                lo, xc, yc, proposal_chunk=proposal_chunk or cifar_chunk,
                device=dev,
            )
            suffix = "" if layout == "nhwc" else "_packed"
            for algo in ("sp_hmc", "mp_hmc", "pmp_hmc"):
                _cell(f"cifar_{algo}{suffix}", mk,
                      _cifar_spec(algo, N, 0.1, 0.0005))
    return cells


def bf16_delta(
    iters: int = 32,
    N: int = 7,
    n_mnist: int = 60000,
    n_cifar: int = 50000,
    class_sep: float = 1.5,
    only=None,
    on_cell=None,
    device=None,
):
    """The bf16 acceptance perturbation of each image cell.

    For each cell, ``iters`` independent supersteps are taken from the
    same warm state (10 Adam steps) with the same generator seeds under
    f32 and bf16 compute; the study reports the move rate under each
    dtype and the mean |delta log-accept-weight|.  The random-walk cells'
    proposals are identical, so their delta is the density's perturbation
    alone; the HMC cells' bf16 gradients also move the proposals, so
    theirs is the whole perturbation.
    """
    dev = resolve_device(device)
    out = {}
    pats = _patterns(only)

    def measure(name, make_target, spec):
        if not _wanted(pats, [name]):
            return
        try:
            t32 = make_target(None)
            t16 = make_target(torch.bfloat16)
            theta = pretrain(t32, 10)

            def ensemble(target, sup):
                las, moved = [], []
                gen = torch.Generator(device=dev)
                with torch.no_grad():
                    for i in range(iters):
                        gen.manual_seed(42 + i)
                        th2, o = sup(gen, theta)
                        las.append(o["log_accept"].float().reshape(-1))
                        moved.append(bool((th2 != theta).any()))
                return torch.stack(las).cpu().numpy(), np.array(moved)

            la32, mv32 = ensemble(t32, spec.build(t32))
            la16, mv16 = ensemble(t16, spec.build(t16))
            cell = {
                "move_rate_f32": float(mv32.mean()),
                "move_rate_bf16": float(mv16.mean()),
                "mean_abs_dlogA": float(np.mean(np.abs(la32 - la16))),
            }
            cell["move_rate_delta"] = round(
                cell["move_rate_bf16"] - cell["move_rate_f32"], 4
            )
            out[name] = cell
        except Exception as e:  # record the failure, keep measuring
            out[name] = {"error": str(e)[:200]}
        _free(dev)
        if on_cell is not None:
            on_cell(name, out[name])

    algos = ("mh", "mp", "pmp")
    if _wanted(pats, [f"mnist_CNN_{a}" for a in algos]):
        x, y, _, _ = load_mnist(n_train=n_mnist, n_test=8,
                                class_sep=class_sep, device=dev)
        for algo in algos:
            measure(
                f"mnist_CNN_{algo}",
                lambda dt: NNPosterior(
                    MNIST_MODELS["CNN"]("nhwc"), x, y, temper=10.0, seed=0,
                    proposal_chunk=2, compute_dtype=dt, device=dev,
                ),
                _mnist_spec(algo, 1e-4, N),
            )
        del x, y
    algos = ("sp_hmc", "mp_hmc", "pmp_hmc")
    if _wanted(pats, [f"cifar_{a}" for a in algos]):
        xc, yc, _, _ = load_cifar10(n_train=n_cifar, n_test=8,
                                    class_sep=class_sep, device=dev)
        for algo in algos:
            measure(
                f"cifar_{algo}",
                lambda dt: _lenet_target(
                    "nhwc", xc, yc, proposal_chunk=1, compute_dtype=dt,
                    device=dev,
                ),
                _cifar_spec(algo, N, 0.1, 0.0005),
            )
    return out


def bf16_chain(
    algo: str = "mh",
    num_steps: int = 10000,
    chunk: int = 500,
    N: int = 7,
    alpha: float = 1e-4,
    n_train: int = 60000,
    n_test: int = 10000,
    class_sep: float = 0.35,
    label_noise: float = 0.05,
    seed: int = 0,
    pretrain_steps: int = 50,
    proposal_chunk: int = 4,
    out_dir: str = "results/bf16_fidelity",
    device=None,
):
    """Chain-level bf16 fidelity at the paper protocol.

    ``bf16_delta`` bounds one superstep's acceptance perturbation; this
    study bounds what a bf16 chain claims: that its statistics match
    f32's.  Two MNIST-CNN chains run the paper cell's protocol (full
    batch, ``class_sep=0.35`` and 5% label noise, ``mnist.run``'s
    per-algorithm temper) from the same pretrained state with the same
    generator seed; only ``compute_dtype`` differs.  Reported per dtype:
    move rate, tail loss mean/std, tail-loss ESS, final train/test
    accuracy; and the coupled ``first_divergence_step`` (the chains draw
    the same noise until a bf16-perturbed density first flips a
    selection).  Writes ``bf16_chain_<algo>.{json,npz}`` under
    ``out_dir``.
    """
    from pmpx_torch.metrics import ess as _ess

    if num_steps % chunk:
        raise ValueError("num_steps must be divisible by chunk")
    dev = resolve_device(device)
    x_tr, y_tr, x_te, y_te = load_mnist(
        n_train=n_train, n_test=n_test, class_sep=class_sep,
        label_noise=label_noise, device=dev,
    )
    temper = 1000.0 if algo == "mh" else 10.0
    spec = _mnist_spec(algo, alpha, N)

    def make_target(dt):
        return NNPosterior(
            MNIST_MODELS["CNN"]("nhwc"), x_tr, y_tr, temper=temper,
            seed=seed, proposal_chunk=proposal_chunk, compute_dtype=dt,
            device=dev,
        )

    # a shared warm start (pretrained on the f32 target: both chains begin
    # from the bitwise-identical theta)
    theta0 = pretrain(make_target(None), pretrain_steps)

    res = {
        "protocol": {
            "cell": f"MNIST_CNN_{algo.upper()}", "num_steps": num_steps,
            "alpha": alpha, "N": N, "temper": temper,
            "n_train": n_train, "class_sep": class_sep,
            "label_noise": label_noise, "seed": seed,
        },
    }
    traces = {}
    os.makedirs(out_dir, exist_ok=True)
    for dname, dt in (("f32", None), ("bf16", torch.bfloat16)):
        target = make_target(dt)
        superstep = spec.build(target)

        def collect(th, o, temper=target.temper):
            moved = o["accepted"] if "accepted" in o else (
                o["root_index"] != 0)
            return (-o["root_logp"].float() / temper,
                    torch.as_tensor(moved, dtype=torch.float32).reshape(()))

        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)
        chain = compile_chain(superstep, gen, theta0, collect)
        theta, loss_parts, mv_parts = theta0, [], []
        with torch.no_grad():
            for ci in range(num_steps // chunk):
                theta, (lo, mv) = chain.run(gen, theta, chunk)
                loss_parts.append(lo.cpu().numpy())
                mv_parts.append(mv.cpu().numpy())
                # a heartbeat a chunk, for a watcher of the out dir
                with open(os.path.join(
                        out_dir, f"progress_{algo}.log"), "a") as pf:
                    pf.write(f"{dname} chunk {ci + 1}/{num_steps // chunk} "
                             f"loss={loss_parts[-1][-1]:.4f}\n")
            loss = np.concatenate(loss_parts).ravel()
            moved = np.concatenate(mv_parts).ravel()
            tail = loss[num_steps // 2:]
            traces[dname] = loss
            res[dname] = {
                "move_rate": float(moved.mean()),
                "loss_mean_tail": float(tail.mean()),
                "loss_std_tail": float(tail.std()),
                "ess_loss_tail": float(_ess(torch.as_tensor(tail))),
                "train_acc": float(target.accuracy(theta, x_tr, y_tr)),
                "test_acc": float(target.accuracy(theta, x_te, y_te)),
            }
        del target, superstep
    # the coupled prefix: the same noise until a perturbed density flips
    # a selection (equal losses are the cheap witness)
    diff = np.nonzero(
        np.abs(traces["f32"] - traces["bf16"])
        > 1e-6 * (1.0 + np.abs(traces["f32"]))
    )[0]
    res["first_divergence_step"] = int(diff[0]) if len(diff) else None
    res["gaps"] = {
        k: res["bf16"][k] - res["f32"][k]
        for k in ("move_rate", "loss_mean_tail", "train_acc", "test_acc")
    }
    with open(os.path.join(out_dir, f"bf16_chain_{algo}.json"), "w") as f:
        json.dump(res, f, indent=1)
    np.savez(
        os.path.join(out_dir, f"bf16_chain_{algo}.npz"),
        loss_f32=traces["f32"], loss_bf16=traces["bf16"],
    )
    return res


def run(
    mode: str = "both",  # footprint | table | both | bf16_delta | bf16_chain
    iters: int = 20,
    N: int = 7,
    P: int = 8,
    n_mnist: int = 60000,
    n_cifar: int = 50000,
    proposal_chunk=None,
    only=None,
    out_dir: str = "results/nn_perf",
    algo: str = "mh",
    num_steps: int = 10000,
    chunk: int = 500,
    class_sep: float = 0.35,
    label_noise: float = 0.05,
    n_test: int = 10000,
    device=None,
):
    """Run ``mode`` and merge its results into ``out_dir/nn_perf.json``,
    written again after every cell (a later failure keeps what was
    measured); ``bf16_chain`` writes its own files.  Returns the merged
    record."""
    if mode == "bf16_chain":
        return bf16_chain(
            algo=algo, num_steps=num_steps, chunk=chunk, N=N,
            n_train=n_mnist, n_test=n_test, class_sep=class_sep,
            label_noise=label_noise, out_dir=out_dir, device=device,
        )
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "nn_perf.json")
    # merge into an existing record so cell-by-cell reruns accumulate;
    # this run's header (backend, device, N) wins
    out = {}
    if os.path.exists(path):
        try:
            with open(path) as fh:
                out.update(json.load(fh))
        except (OSError, ValueError):
            pass
    out["backend"] = dev.type
    if dev.type == "cuda":
        out["device"] = torch.cuda.get_device_name(dev)
    out["N"] = N
    out.setdefault("us_per_superstep", {})

    def _dump():
        with open(path, "w") as fh:
            json.dump(out, fh, indent=1)

    def _on_cell(name, value):
        out["us_per_superstep"][name] = value
        _dump()

    if mode in ("footprint", "both"):
        out["footprint"] = footprint(P=P, n_train=n_cifar, device=dev)
        _dump()
    if mode in ("table", "both"):
        table(
            iters=iters, N=N, n_mnist=n_mnist, n_cifar=n_cifar,
            proposal_chunk=proposal_chunk, only=only, on_cell=_on_cell,
            device=dev,
        )
        _dump()
    if mode == "bf16_delta":
        out.setdefault("bf16_delta", {})

        def _on_delta(name, value):
            out["bf16_delta"][name] = value
            _dump()

        bf16_delta(
            iters=iters, N=N, n_mnist=n_mnist, n_cifar=n_cifar,
            only=only, on_cell=_on_delta, device=dev,
        )
        _dump()
    return out
