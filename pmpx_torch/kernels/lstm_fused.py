"""Fused LSTM-posterior forward: all P speculative networks in one kernel
(port of ``pmpx/kernels/lstm_fused.py``).

The MNIST LSTM posterior (reference ``complex_nets/Mnist/LSTM/
PMP_LSTM.py``: 28-step row sequence, 64 hidden units, the full batch of
60,000) evaluates P parameter sets per superstep.  :func:`lstm_final_hidden`
launches the CUDA kernel ``csrc/lstm_fused.cu`` for CUDA tensors: the whole
28-step recurrence of every (batch tile, p) runs in one block, both gate
products on the tensor cores (3xTF32 through ``wgmma`` in float32, one
bfloat16 ``mma.sync`` product in bfloat16), the cell update in registers,
and only the final hidden states (P, B, H) reach device memory.  For CPU
tensors it runs the plain version :func:`lstm_final_hidden_ref`, a 28-step
loop.

The weights follow flax's ``OptimizedLSTMCell``: gate columns [i|f|g|o],
input kernels ``i{i,f,g,o}`` without bias, the one bias on the hidden side.
:func:`attach` wires the kernel into an ``NNPosterior`` over
``pmpx_torch.models.MnistLSTM`` as its ``log_prob_batch``; the Dense head
and the cross-entropy stay plain torch in f32, as ``pmpx`` leaves them to
XLA.  The random-walk MTM samplers of the MNIST protocol need no
gradients, so the forward-only kernel covers the whole chain.
"""

from __future__ import annotations

import types

import torch
import torch.nn.functional as F

from pmpx_torch import _build
from pmpx_torch.kernels import launches
from pmpx_torch.models.lstm import GATES

__all__ = [
    "lstm_final_hidden",
    "lstm_final_hidden_ref",
    "make_fast_log_prob_batch",
    "attach",
    "gate_weights",
    "replay_against_plain",
]

_CELL = "OptimizedLSTMCell_0"
_KERNEL_F, _KERNEL_H = 28, 64  # the shapes csrc/lstm_fused.cu is built for
_DTYPES = (torch.float32, torch.bfloat16)


def _check(x_tm, Wx, Wh, b) -> None:
    if x_tm.dtype not in _DTYPES:
        raise TypeError(f"x_tm must be float32 or bfloat16, got {x_tm.dtype}")
    for name, t, dt in (("Wx", Wx, x_tm.dtype), ("Wh", Wh, x_tm.dtype),
                        ("b", b, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
    for name, t in (("x_tm", x_tm), ("Wx", Wx), ("Wh", Wh), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x_tm.device:
            raise ValueError(f"{name} is on {t.device}, x_tm on "
                             f"{x_tm.device}")
    if x_tm.dim() != 3 or Wx.dim() != 3 or Wh.dim() != 3 or b.dim() != 2:
        raise ValueError("expected x_tm (T, B, F), Wx (P, F, 4H), "
                         "Wh (P, H, 4H), b (P, 4H)")
    T, B, Fdim = x_tm.shape
    P, _, G = Wx.shape
    H = G // 4
    if (G % 4 or Wx.shape != (P, Fdim, G) or Wh.shape != (P, H, G)
            or b.shape != (P, G)):
        raise ValueError(
            f"shapes do not match: x_tm {tuple(x_tm.shape)}, Wx "
            f"{tuple(Wx.shape)}, Wh {tuple(Wh.shape)}, b {tuple(b.shape)}"
        )
    if min(T, B, P) == 0:
        raise ValueError("empty input")


def lstm_final_hidden(x_tm: torch.Tensor, Wx: torch.Tensor, Wh: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Final hidden state of a zero-carry LSTM for P parameter sets.

    x_tm : (T, B, F) time-major input, one dataset shared by all P.
    Wx : (P, F, 4H) input kernels; Wh : (P, H, 4H) hidden kernels, gate
        columns [i|f|g|o]; x_tm, Wx, Wh float32, or bfloat16 (then h is
        rounded to bfloat16 before each hidden product).
    b : (P, 4H) float32 hidden biases.
    Returns (P, B, H) float32.  The kernel takes F = 28 and H = 64, and
    x_tm aligned to 16 bytes in float32 or 8 in bfloat16 (any tensor of
    its own storage is).
    """
    _check(x_tm, Wx, Wh, b)
    dev = x_tm.device
    if dev.type == "cpu":
        return lstm_final_hidden_ref(x_tm, Wx, Wh, b)
    if dev.type != "cuda":
        raise ValueError(f"lstm_final_hidden runs on cuda or cpu, not {dev}")
    T, B, Fdim = x_tm.shape
    P, _, G = Wx.shape
    H = G // 4
    if (Fdim, H) != (_KERNEL_F, _KERNEL_H):
        raise ValueError(f"the lstm_fused kernel takes F = {_KERNEL_F} and "
                         f"H = {_KERNEL_H}, got F = {Fdim}, H = {H}")
    lib = _build.load().lib
    out = torch.empty((P, B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pmpx_lstm_fused(
            int(x_tm.dtype == torch.bfloat16), x_tm.data_ptr(),
            Wx.data_ptr(), Wh.data_ptr(), b.data_ptr(), out.data_ptr(),
            T, B, Fdim, H, P, stream,
        )
    _build.check(err, "lstm_fused")
    launches["lstm_fused"] += 1
    return out


def lstm_final_hidden_ref(x_tm: torch.Tensor, Wx: torch.Tensor,
                          Wh: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`lstm_final_hidden`: the 28-step
    loop in float32, h rounded to the input type before each hidden
    product (exact products of bfloat16 values, f32 sums)."""
    T, B, _ = x_tm.shape
    P, _, G = Wx.shape
    H = G // 4
    dt = x_tm.dtype
    wx, wh = Wx.float(), Wh.float()
    h = torch.zeros((P, B, H), dtype=torch.float32, device=x_tm.device)
    c = torch.zeros_like(h)
    for t in range(T):
        z = (torch.matmul(x_tm[t].float(), wx)
             + torch.bmm(h.to(dt).float(), wh) + b[:, None, :])
        zi, zf, zg, zo = z.chunk(4, dim=-1)
        c = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
        h = torch.sigmoid(zo) * torch.tanh(c)
    return h


def _gate_stack(leaves: dict, side: str) -> torch.Tensor:
    """Concatenate the named per-gate kernels ``{side}{g}.kernel`` into
    flax's [i|f|g|o] column layout."""
    return torch.cat(
        [leaves[f"{_CELL}.{side}{g}.kernel"] for g in GATES], dim=-1
    )


def gate_weights(posterior, Theta: torch.Tensor):
    """(Wx, Wh, b) of the P networks in ``Theta`` (P, d), stacked from the
    named theta leaves as the kernel takes them: Wx, Wh in the posterior's
    ``compute_dtype`` (f32 when None), b in f32."""
    leaves = posterior.unravel(Theta)
    Wx, Wh = _gate_stack(leaves, "i"), _gate_stack(leaves, "h")
    b = torch.cat([leaves[f"{_CELL}.h{g}.bias"] for g in GATES], dim=-1)
    dt = posterior.compute_dtype or torch.float32
    return (Wx.to(dt).contiguous(), Wh.to(dt).contiguous(),
            b.float().contiguous())


def make_fast_log_prob_batch(posterior, *, hidden=lstm_final_hidden):
    """A ``log_prob_batch(Theta)`` for an NNPosterior over ``MnistLSTM``
    through ``hidden`` (the kernel, or its plain version for a replay).

    Keeps one time-major (T, B, F) copy of ``posterior.X`` per bound
    dataset (made again only when ``posterior.X`` is another tensor), and
    honours ``posterior.compute_dtype`` as the generic path does: x, Wx and
    Wh in that type, the bias, head and loss in f32.
    """
    cache = {}

    def time_major():
        X = posterior.X
        if cache.get("X") is not X:
            steps = posterior.model.steps
            cache["X"] = X
            cache["x_tm"] = X.reshape(X.shape[0], steps, -1).transpose(
                0, 1).contiguous()
        return cache["x_tm"]

    def fast(Theta: torch.Tensor) -> torch.Tensor:
        leaves = posterior.unravel(Theta)
        hfin = hidden(time_major(), *gate_weights(posterior, Theta))
        logits = (torch.einsum("pbh,pho->pbo", hfin,
                               leaves["Dense_0.kernel"].float())
                  + leaves["Dense_0.bias"].float()[:, None, :])
        P, B, C = logits.shape
        ce = F.cross_entropy(logits.reshape(P * B, C),
                             posterior.Y.repeat(P),
                             reduction="none").reshape(P, B).mean(dim=1)
        return -posterior.temper * ce

    return fast


def attach(posterior) -> None:
    """Install the fused-kernel density on an MnistLSTM NNPosterior.

    After this, ``log_prob_batch`` and ``log_prob`` evaluate through the
    kernel (the same math as the generic path; float reassociation only).
    ``value_and_grad_batch`` keeps the generic path.  Raises
    ``ValueError`` for a posterior over another model, or a stochastic one.
    """
    paths = {path for path, _, _ in getattr(posterior, "layout", ())}
    want = {"Dense_0.kernel", "Dense_0.bias"}
    for g in GATES:
        want |= {f"{_CELL}.i{g}.kernel", f"{_CELL}.h{g}.kernel",
                 f"{_CELL}.h{g}.bias"}
    if not want <= paths:
        raise ValueError(
            "attach() requires an NNPosterior over "
            "pmpx_torch.models.MnistLSTM (OptimizedLSTMCell_0 + Dense_0 "
            f"leaves); missing {sorted(want - paths)[:3]}"
        )
    if posterior.stochastic:
        raise ValueError("fused LSTM kernel is deterministic-only")
    posterior._fast_batch = make_fast_log_prob_batch(posterior)


def replay_against_plain(posterior, cfg, theta0: torch.Tensor,
                         eps: torch.Tensor, u: torch.Tensor):
    """Run ``len(eps)`` PMP supersteps (``cfg``, a ``PMPConfig``) over
    ``posterior``, attached to the kernel, on injected innovations ``eps``
    (steps, P, d) and uniforms ``u`` (steps, 1 or P), and run each one
    again from the kernel path's state through the plain version.

    Returns ``(agree, err)``: how many supersteps chose the same node, and
    the max |difference| of the next state where they did (0 when the
    states are bit-equal).
    """
    from pmpx_torch.samplers import pmp

    plain = types.SimpleNamespace(
        d=posterior.d,
        log_prob_batch=make_fast_log_prob_batch(
            posterior, hidden=lstm_final_hidden_ref),
    )
    sup_kernel = pmp.make_superstep(posterior, cfg)
    sup_plain = pmp.make_superstep(plain, cfg)
    agree, err = 0, 0.0
    with torch.no_grad():
        theta = theta0
        for e, uu in zip(eps, u):
            nxt, out = sup_kernel(None, theta, eps=e, u=uu)
            ref, out_ref = sup_plain(None, theta, eps=e, u=uu)
            if int(out["root_index"]) == int(out_ref["root_index"]):
                agree += 1
                err = max(err, float((nxt - ref).abs().max()))
            theta = nxt
    return agree, err
