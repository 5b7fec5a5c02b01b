"""Mamba-2's SSD scan for many sequences in one CUDA kernel
(``csrc/mamba2_ssd.cu``), beside its plain versions.

The state-space mixer of a Mamba-2 layer (``granitemoehybrid``'s
``mamba`` layers; :mod:`pmpx_torch.models.granite_hybrid`) runs, per
sequence and head, the recurrence

    S_t = exp(dt_t * A) * S_{t-1} + dt_t * x_t (outer) B_t,
    y_t = S_t C_t + D * x_t,

with S (head_dim, d_state), S_0 = 0, x_t the head's channels, B_t and C_t
shared by the heads (one group), dt_t > 0 per head and A < 0, D per head.
A PMP superstep evaluates it for P proposals of B sequences each, every
proposal with its own A and D: P * B sequences, 64 heads, 4,096 positions
a layer at the published widths.  No TPU kernel of the JAX package
computes it; no other kernel here does.

:func:`mamba2_ssd` launches ``mamba2_ssd_kernel`` for CUDA tensors: one
block of 8 warps a (sequence, head) walks the positions in order with the
(64, 128) state in float32 registers (a warp 8 rows, a lane 4 entries of
each), staging 16 positions of x, B, C and dt at a time in shared memory,
and carries the state divided by its decay since a base that moves on
wherever that decay would pass e^-30 (two fmas a state entry and
position; ``csrc/mamba2_ssd.cu`` says why).  Every product and sum is float32; y is written in x's type.
On the H100 the bytes of x and y and the ~5 * 64 * 128 flops a head and
position would allow well under a millisecond a layer; the kernel takes
~17 ms, each block latency-bound along its 4,096 positions (PERF.md).  The
kernel takes head_dim 64 and d_state 128 (the published widths).

:func:`ssd_sequential` is the recurrence itself, one position at a time:
the kernel's plain version.  :func:`ssd_chunked_ref` computes the same
sums regrouped in chunks of ``chunk`` positions (Mamba-2's chunked form:
within a chunk of cumulative log-decays c_t,
y_t = exp(c_t) S_prev C_t + sum_{u<=t} exp(c_t - c_u) dt_u (C_t.B_u) x_u
+ D x_t), which a CPU runs far faster; it is the path of CPU tensors.
``launches["mamba2_ssd"]`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from pmpx_torch import _build
from pmpx_torch.kernels import launches

__all__ = ["CHUNK", "mamba2_ssd", "ssd_chunked_ref", "ssd_sequential"]

CHUNK = 32  # the CPU path's chunk
HEAD_DIM, D_STATE = 64, 128  # the widths the kernel takes


def _check(x, dt, A, B, C, D) -> tuple:
    if x.dim() != 4:
        raise ValueError(f"x must be (S, T, H, head_dim), got "
                         f"{tuple(x.shape)}")
    S, T, H, hd = x.shape
    N = B.shape[-1]
    for name, t, shape in (("dt", dt, (S, T, H)), ("A", A, (S, H)),
                           ("B", B, (S, T, N)), ("C", C, (S, T, N)),
                           ("D", D, (S, H))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("dt", dt), ("A", A), ("D", D)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"B and C must be {x.dtype} as x is, got "
                        f"{B.dtype}, {C.dtype}")
    return S, T, H, hd, N


def mamba2_ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, C: torch.Tensor,
               D: torch.Tensor) -> torch.Tensor:
    """y (S, T, H, head_dim) in x's type, the D skip included.

    x (S, T, H, head_dim) float32 or bfloat16, any strides; dt (S, T, H)
    float32 (after the softplus); A and D (S, H) float32, each sequence
    with its own; B and C (S, T, d_state) in x's type, any strides.  The
    state starts at 0 in each sequence.  A CPU tensor takes
    :func:`ssd_chunked_ref`; a CUDA one the kernel, which takes head_dim
    64 and d_state 128.
    """
    S, T, H, hd, N = _check(x, dt, A, B, C, D)
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, A, B, C, D)
    if x.device.type != "cuda":
        raise ValueError(f"mamba2_ssd runs on cuda or cpu, not {x.device}")
    if (hd, N) != (HEAD_DIM, D_STATE):
        raise ValueError(f"the kernel takes head_dim {HEAD_DIM} and d_state "
                         f"{D_STATE}, not {hd} and {N}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes float32 or bfloat16, not "
                        f"{x.dtype}")
    A, D = A.contiguous(), D.contiguous()
    y = torch.empty((S, T, H, hd), dtype=x.dtype, device=x.device)
    strides = (ctypes.c_longlong * 17)(*x.stride(), *dt.stride(),
                                       *B.stride(), *C.stride(), *y.stride())
    args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), y.data_ptr(), S, T, H, hd, N,
            int(x.dtype == torch.bfloat16), ctypes.addressof(strides))
    fn = _build.load().lib.pmpx_mamba2_ssd
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "mamba2_ssd")
    launches["mamba2_ssd"] += 1
    return y


def ssd_chunked_ref(x, dt, A, B, C, D, chunk: int = CHUNK,
                    state_dtype: torch.dtype = torch.float32):
    """The path of CPU tensors: the recurrence's sums regrouped in chunks
    of ``chunk`` positions, in torch, in float32 (the inputs' values), y in
    x's type.  ``chunk`` need not divide T.  ``state_dtype`` rounds the
    state carried between chunks (float32 on the program's path)."""
    S, T, H, hd, N = _check(x, dt, A, B, C, D)
    state = torch.zeros((S, H, hd, N), dtype=torch.float32,
                        device=x.device)
    A, D = A.float(), D.float()
    ys = []
    for t0 in range(0, T, chunk):
        xs = x[:, t0:t0 + chunk].float()
        dts = dt[:, t0:t0 + chunk].float()
        Bs, Cs = B[:, t0:t0 + chunk].float(), C[:, t0:t0 + chunk].float()
        L = xs.shape[1]
        cum = torch.cumsum(dts * A[:, None, :], dim=1)  # (S, L, H)
        causal = torch.ones(L, L, dtype=torch.bool,
                            device=x.device).tril()[None, :, :, None]
        expo = cum[:, :, None, :] - cum[:, None, :, :]  # (S, t, u, H)
        decay = torch.exp(torch.where(causal, expo,
                                      torch.full_like(expo, -torch.inf)))
        G = torch.einsum("stn,sun->stu", Cs, Bs)
        W = G[..., None] * decay * dts[:, None, :, :]
        y = torch.einsum("stuh,suhp->sthp", W, xs)
        y = y + torch.einsum("stn,shpn->sthp", Cs, state) * torch.exp(
            cum)[..., None]
        y = y + D[:, None, :, None] * xs
        ys.append(y)
        total = cum[:, -1]  # (S, H)
        wend = torch.exp(total[:, None, :] - cum) * dts  # (S, L, H)
        state = (state * torch.exp(total)[..., None, None]
                 + torch.einsum("suh,suhp,sun->shpn", wend, xs, Bs))
        state = state.to(state_dtype).float()
    return torch.cat(ys, dim=1).to(x.dtype)


def ssd_sequential(x, dt, A, B, C, D):
    """The kernel's plain version: the recurrence one position at a time,
    in float32; y in x's type."""
    S, T, H, hd, N = _check(x, dt, A, B, C, D)
    state = torch.zeros((S, H, hd, N), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(T):
        xt, dtt = x[:, t].float(), dt[:, t].float()
        decay = torch.exp(dtt * A.float())[..., None, None]
        state = decay * state + (dtt[..., None] * xt)[..., None] * B[
            :, t].float()[:, None, None, :]
        ys.append(torch.einsum("shpn,sn->shp", state, C[:, t].float())
                  + D.float()[..., None] * xt)
    return torch.stack(ys, dim=1).to(x.dtype)
