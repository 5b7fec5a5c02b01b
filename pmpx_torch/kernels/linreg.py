"""Batched residual sum of squares for Bayesian linreg (port of
``pmpx/kernels/linreg.py``).

``batched_rss`` launches the CUDA kernel ``csrc/linreg_rss.cu`` for CUDA
tensors and runs its plain version ``batched_rss_ref`` for CPU tensors.
The padded-data contract is the one of ``pmpx``: data as a (rows, 128)
zero-padded grid, where each padded point adds b0^2 that the caller
subtracts, and proposals padded by :func:`pad_proposals`.  With
``n_valid`` the sum runs over the first ``n_valid`` points only and the
zero tail is never read (nothing to subtract).
"""

from __future__ import annotations

import ctypes
import operator

import torch

from pmpx_torch import _build
from pmpx_torch.kernels import launches

__all__ = ["batched_rss", "batched_rss_ref", "kernel_info", "pad_proposals"]

_LANES = 128
_TP = 64  # proposal multiple above 64 (pmpx's in-kernel chunk)
_ROWS = 128  # data rows per block of the padded grid
# what pmpx_linreg_rss_info reports, in its order
_INFO = ("clusters", "cluster_size", "threads", "max_clusters", "registers",
         "static_smem_bytes", "dynamic_smem_bytes", "blocks_per_sm", "sms")


def pad_proposals(b0: torch.Tensor, b1: torch.Tensor):
    """Zero-pad proposal vectors to a batch size ``batched_rss`` accepts:
    any P <= 64 padded to a multiple of 8, above that a multiple of 64.
    Returns (b0_padded, b1_padded, original_P)."""
    P = b0.shape[0]
    mult = _TP if P > _TP else 8
    pad = (-P) % mult
    if pad:
        z = b0.new_zeros((pad,))
        b0 = torch.cat([b0, z])
        b1 = torch.cat([b1, z])
    return b0, b1, P


def _check(b0, b1, x2d, y2d) -> None:
    for name, t in (("b0", b0), ("b1", b1), ("x2d", x2d), ("y2d", y2d)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != b0.device:
            raise ValueError(
                f"{name} is on {t.device}, b0 on {b0.device}"
            )
    if b0.dim() != 1 or b1.shape != b0.shape:
        raise ValueError(
            f"b0, b1 must be matching (P,), got {tuple(b0.shape)}, "
            f"{tuple(b1.shape)}"
        )
    if x2d.dim() != 2 or x2d.shape[1] != _LANES or y2d.shape != x2d.shape:
        raise ValueError(
            f"x2d, y2d must be matching (rows, {_LANES}), got "
            f"{tuple(x2d.shape)}, {tuple(y2d.shape)}"
        )
    P, rows = b0.shape[0], x2d.shape[0]
    if P == 0 or rows == 0:
        raise ValueError("empty proposals or data")
    tp = min(_TP, P)
    if P % tp:
        raise ValueError(f"P={P} must be a multiple of {tp}")
    row_blk = min(_ROWS, rows)
    if rows % row_blk:
        raise ValueError(f"rows={rows} must be a multiple of {row_blk}")


def _points(n_valid, slots: int) -> int:
    if n_valid is None:
        return slots
    n = operator.index(n_valid)
    if not 1 <= n <= slots:
        raise ValueError(f"n_valid={n_valid} must be in [1, {slots}]")
    return n


def batched_rss(
    b0: torch.Tensor, b1: torch.Tensor, x2d: torch.Tensor, y2d: torch.Tensor,
    *, n_valid: int | None = None,
) -> torch.Tensor:
    """RSS of P linear models over lane-major data -> (P,) float32.

    b0, b1 : (P,) proposal parameters (P <= 64, or a multiple of 64).
    x2d, y2d : (rows, 128) data, zero-padded at the tail.
    n_valid : None sums every slot, and each padded point contributes
        b0^2, which the caller subtracts; an int sums the first
        ``n_valid`` points only.
    """
    _check(b0, b1, x2d, y2d)
    n = _points(n_valid, x2d.numel())
    dev = b0.device
    if dev.type == "cpu":
        return batched_rss_ref(b0, b1, x2d, y2d, n_valid=n_valid)
    if dev.type != "cuda":
        raise ValueError(f"batched_rss runs on cuda or cpu, not {dev}")
    if (x2d.data_ptr() | y2d.data_ptr()) % 16:
        raise ValueError("x2d, y2d must start on a 16-byte boundary")
    lib = _build.load().lib
    P = b0.shape[0]
    out = torch.empty((P,), device=dev)
    if dev.index == torch.cuda.current_device():
        err = _launch(lib, b0, b1, x2d, y2d, out, P, n)
    else:
        with torch.cuda.device(dev):
            err = _launch(lib, b0, b1, x2d, y2d, out, P, n)
    _build.check(err, "linreg_rss")
    launches["linreg_rss"] += 1
    return out


def _launch(lib, b0, b1, x2d, y2d, out, P, n) -> int:
    return lib.pmpx_linreg_rss(
        b0.data_ptr(), b1.data_ptr(), x2d.data_ptr(), y2d.data_ptr(),
        out.data_ptr(), P, n, torch.cuda.current_stream().cuda_stream,
    )


def kernel_info(P: int, n: int) -> dict:
    """The launch ``batched_rss`` makes on the current CUDA device for P
    proposals over n points: clusters, blocks a cluster, threads a block,
    the clusters of that size the card holds at once
    (``cudaOccupancyMaxActiveClusters``), registers a thread, static and
    dynamic shared bytes a block, blocks an SM holds, and the SMs."""
    info = (ctypes.c_int * len(_INFO))()
    _build.check(_build.load().lib.pmpx_linreg_rss_info(
        int(P), int(n), ctypes.cast(info, ctypes.c_void_p)), "linreg_rss")
    return dict(zip(_INFO, info))


def batched_rss_ref(
    b0: torch.Tensor, b1: torch.Tensor, x2d: torch.Tensor, y2d: torch.Tensor,
    *, n_valid: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`batched_rss` (``pmpx``'s
    ``batched_rss_xla``): the sweep in blocks of 128 data rows, over the
    first ``n_valid`` points (every slot when None)."""
    P, rows = b0.shape[0], x2d.shape[0]
    n = _points(n_valid, x2d.numel())
    xs_all = x2d.reshape(-1)[:n]
    ys_all = y2d.reshape(-1)[:n]
    blk = min(_ROWS, rows) * _LANES
    acc = torch.zeros((P,), dtype=torch.float32, device=b0.device)
    for i0 in range(0, n, blk):
        xs = xs_all[i0:i0 + blk]
        ys = ys_all[i0:i0 + blk]
        r = ys[None, :] - b0[:, None] - b1[:, None] * xs[None]
        acc = acc + torch.sum(r * r, dim=1)
    return acc
