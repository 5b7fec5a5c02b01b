"""The binary PMP superstep's tree in two CUDA kernels
(``csrc/pmp_tree.cu``), each beside its plain version.

:func:`tree_positions` writes the tree's P positions from the chains'
states and innovations (before the target call); :func:`tree_select`
computes the per-node weights from the log-densities, stabilises them,
draws, picks each chain's next root and gathers the emitted rows (after
it).  ``pmp.make_superstep`` takes them where :func:`engages` holds: a
binary tree (``N == 1``) whose log-densities, weights and draws fit one
block's shared memory (``depth <= MAX_DEPTH``), over float32 states on a
card.  The plain versions are the port's torch functions
(``samplers.pmp.tree_positions``, ``log_accept_tree``,
``samplers.stabilize.stabilize_logits`` and ``select_and_emit``); a
wrapper runs them for CPU tensors and, for CUDA tensors, launches or
raises.  The emitted rows ride in the select kernel's blocks up to
``BLOCK_COPY`` elements a chain; above, a third, grid-wide launch gathers
them.
"""

from __future__ import annotations

import torch

from pmpx_torch import _build
from pmpx_torch.kernels import launches

__all__ = ["MAX_DEPTH", "BLOCK_COPY", "engages", "tree_positions",
           "tree_positions_ref", "tree_select", "tree_select_ref"]

MAX_DEPTH = 14  # (3 + 1/32) * 2**14 floats of shared memory a block
BLOCK_COPY = 1 << 16  # elements of emitted rows a chain's block copies
_MODES = {"all_uniform": 0, "all_first": 1, "single": 2}


def engages(cfg, theta: torch.Tensor) -> bool:
    """Whether a superstep of ``cfg`` (a ``PMPConfig``) from ``theta``
    takes the tree kernels."""
    return (cfg.N == 1 and cfg.depth <= MAX_DEPTH and theta.is_cuda
            and theta.dtype == torch.float32)


def _check(device, **tensors) -> None:
    for name, (t, shape, dtype) in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the tree kernels run on cuda or cpu, not {device}")


def _depth(depth: int) -> int:
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"depth must be in [1, {MAX_DEPTH}], got {depth}")
    return depth


def _launch(device, fn, *args) -> int:
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(device):
        return fn(*args, stream)


def tree_positions(theta: torch.Tensor, eps: torch.Tensor, depth: int,
                   scale: float = 1.0) -> torch.Tensor:
    """Y (C, P, d) of C chains' binary trees of P = 2**depth states from
    theta (C, d) and the innovations eps (C, P, d), each times ``scale``
    (the step size, where eps is a raw normal draw): bit-equal to
    ``samplers.pmp.tree_positions(theta, scale * eps, topology(1, depth))``.
    """
    P = 1 << _depth(depth)
    if theta.dim() != 2:
        raise ValueError(f"theta must be (C, d), got {tuple(theta.shape)}")
    C, d = theta.shape
    _check(theta.device, theta=(theta, (C, d), torch.float32),
           eps=(eps, (C, P, d), torch.float32))
    if theta.device.type == "cpu":
        return tree_positions_ref(theta, eps, depth, scale)
    Y = torch.empty((C, P, d), device=theta.device)
    err = _launch(theta.device, _build.load().lib.pmpx_tree_positions,
                  theta.data_ptr(), eps.data_ptr(), Y.data_ptr(), C, depth, d,
                  float(scale))
    _build.check(err, "tree_positions")
    launches["pmp_tree_positions"] += 1
    return Y


def tree_select(cfg, Y: torch.Tensor, logpi: torch.Tensor, u: torch.Tensor,
                pick: torch.Tensor | None = None):
    """The weights, selection and emission of C chains' binary trees after
    the target call, for ``cfg`` (a ``PMPConfig`` with ``N == 1``).

    Y (C, P, d) and logpi (C, P) float32; u (C, 1) float32 for
    ``single``, else (C, P); pick (C,) int64, each chain's root slot, for
    ``all_uniform`` (ignored otherwise).  Returns ``(theta2, samples,
    root_index, log_accept, root_logp)``: (C, d), (C, P, d) or for
    ``single`` (C, 1, d), (C,) int32, (C, P) and (C,), as the plain
    version's ``select_and_emit`` and ``log_accept_tree`` give them.
    """
    if cfg.N != 1:
        raise ValueError(f"the tree kernels take binary trees, not N={cfg.N}")
    depth = _depth(cfg.depth)
    P = 1 << depth
    if Y.dim() != 3:
        raise ValueError(f"Y must be (C, P, d), got {tuple(Y.shape)}")
    C, d = Y.shape[0], Y.shape[2]
    num = 1 if cfg.selection == "single" else P
    tensors = dict(Y=(Y, (C, P, d), torch.float32),
                   logpi=(logpi, (C, P), torch.float32),
                   u=(u, (C, num), torch.float32))
    if cfg.selection == "all_uniform":
        if pick is None:
            raise ValueError("all_uniform needs pick, each chain's root slot")
        tensors["pick"] = (pick, (C,), torch.int64)
    else:
        pick = None
    _check(Y.device, **tensors)
    if Y.device.type == "cpu":
        return tree_select_ref(cfg, Y, logpi, u, pick)
    dev = Y.device
    log_accept = torch.empty((C, P), device=dev)
    root = torch.empty((C,), dtype=torch.int32, device=dev)
    root_logp = torch.empty((C,), device=dev)
    theta2 = torch.empty((C, d), device=dev)
    single = cfg.selection == "single"
    samples = None if single else torch.empty((C, P, d), device=dev)
    rows = 1 if single else P + 1
    gather = rows * d > BLOCK_COPY
    draws = (torch.empty((C, num), dtype=torch.int32, device=dev)
             if gather else None)
    err = _launch(
        dev, _build.load().lib.pmpx_tree_select, logpi.data_ptr(),
        Y.data_ptr(), u.data_ptr(), None if pick is None else pick.data_ptr(),
        log_accept.data_ptr(), root.data_ptr(), root_logp.data_ptr(),
        theta2.data_ptr(), None if samples is None else samples.data_ptr(),
        None if draws is None else draws.data_ptr(), C, depth, d,
        _MODES[cfg.selection], int(cfg.stabilizer == "zscore"),
        int(cfg.nan_guard))
    _build.check(err, "tree_select")
    launches["pmp_tree_select"] += 1
    if gather:
        launches["pmp_tree_gather"] += 1
    if single:
        samples = theta2[:, None, :]
    return theta2, samples, root, log_accept, root_logp


def tree_positions_ref(theta, eps, depth, scale=1.0):
    """:func:`tree_positions`' plain version: the port's torch function."""
    from pmpx_torch import tree
    from pmpx_torch.samplers import pmp

    return pmp.tree_positions(theta, eps if scale == 1.0 else scale * eps,
                              tree.topology(1, depth))


def tree_select_ref(cfg, Y, logpi, u, pick=None):
    """:func:`tree_select`'s plain version: the port's torch functions."""
    from pmpx_torch.samplers import pmp
    from pmpx_torch.samplers.stabilize import stabilize_logits

    log_accept = pmp.log_accept_tree(Y, logpi, cfg.topology(),
                                     cfg.transition())
    logits = stabilize_logits(log_accept, cfg.stabilizer, cfg.nan_guard)
    theta2, samples, root = pmp.select_and_emit(cfg, Y, logits, None, u=u,
                                                pick=pick)
    return theta2, samples, root, log_accept, pmp._take(logpi, root)
