"""Whole chunks of an MP/PMP chain over Bayesian linreg in one launch
(port of ``pmpx/kernels/fused_chain.py``, ``emit="root"`` and
``emit="all"``), and a farm of such chains in one launch.

Three modes, chosen from the config as ``pmpx`` chooses them
(:func:`chain_mode`): ``binary`` (N = 1), ``mp`` (flat MTM, depth 1) and
``general`` ((N, depth) trees with a power-of-two base N + 1).
:func:`chain_chunk` runs ``steps`` supersteps of one chain, or of a farm
of C chains (one block each): the mode's CUDA kernel in
``csrc/fused_chain.cu`` for CUDA tensors, its plain version
:func:`fused_chain_ref` for CPU tensors.  :func:`make_fused_chain` builds
the chain runner over chunks, the counterpart of ``pmpx``'s.

``emit="all"`` is the reference's ESS protocol (``selection="all_first"``):
each superstep draws P iid slots from the weights, slot 0's draw is the
next state, and the kernel emits every slot's b0, the within-step
squared-jump sum and the last slot's state (:func:`ref_emit`).

Uniforms: ``rng="kernel"`` draws them in the kernel from a Philox stream
keyed by one seed per chunk, the seeds drawn from the caller's
``torch.Generator``; ``rng="input"`` takes 17 rows of L lanes per
superstep (rows 0-7 u1, 8-15 u2 for Box-Muller, of which rows 0-2 and lanes
< P are used; row 16 lane 0 the selection uniform), all in (0, 1] and laid
out as ``pmpx``'s, so both packages can be fed the same numbers;
``emit="all"`` adds one (steps, L) row of slot uniforms per superstep,
slot j on lane j, as ``pmpx``'s ``uemit``.  On the CPU there is no
in-kernel generator, so ``rng="kernel"`` draws input uniforms from the
generator instead, as ``pmpx`` does off the TPU.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from pmpx_torch import _build
from pmpx_torch.kernels import launches

__all__ = [
    "supports",
    "spec_to_cfg",
    "chain_mode",
    "trans_norm",
    "make_fused_chain",
    "chain_consts",
    "chain_chunk",
    "fused_chain_ref",
    "ref_step",
    "ref_emit",
    "replay_against_plain",
    "replay_roots_against_plain",
    "replay_emit_against_plain",
    "suff_stats",
    "lane_extent",
    "KERNEL_NAME",
    "KERNEL_NAME_ALL",
    "FARM_KERNEL",
    "U_ROWS",
    "EMIT_MAX_L",
]

_LANES = 128
_MAX_P = 1024
_LOG_2PI = math.log(2.0 * math.pi)
U_ROWS = 17  # injected uniform rows per superstep
# pmpx's VMEM budget for the general walk's depth x (L, L) f32 group
# matrices.  The CUDA kernel holds no such matrices; the cap is kept so
# that supports() answers exactly as pmpx's does and both packages time
# the same path per cell.
_GROUP_MAT_BYTES = 8 * 2**20
# emit="all" caps the lane extent at 512, as pmpx's supports() does (its
# (L, L) compare and one-hot intermediates had to fit VMEM); the CUDA
# kernel sizes its emit buffers for it
EMIT_MAX_L = 512
# the launch counter (pmpx_torch.kernels.launches) of each mode's kernel,
# for one chain with emit="root", one chain with emit="all", and a farm of
# chains (emit="root", any mode)
KERNEL_NAME = {
    "binary": "fused_chain",
    "mp": "fused_chain_mp",
    "general": "fused_chain_general",
}
KERNEL_NAME_ALL = {
    "binary": "fused_chain_all",
    "mp": "fused_chain_mp_all",
    "general": "fused_chain_general_all",
}
FARM_KERNEL = "fused_chain_farm"
# the mode argument of the C entry point
_MODE_ID = {"binary": 0, "mp": 1, "general": 2}


def lane_extent(P: int) -> int:
    """Threads (lanes) the kernel runs for P nodes: P rounded up to 128."""
    return -(-max(P, _LANES) // _LANES) * _LANES


def supports(cfg, emit: str = "root") -> bool:
    """Whether this port implements cfg's sampler exactly: what
    ``pmpx.kernels.fused_chain.supports(cfg, emit)`` answers (P <= 1024,
    stabilizer "none"; binary trees and flat MP of any size, general
    (N, depth) trees with a power-of-two base whose group matrices would
    fit pmpx's 8 MiB; ``emit="all"`` only up to a lane extent of 512)."""
    base = cfg.N + 1
    P = base**cfg.depth
    if not (P <= _MAX_P and cfg.stabilizer == "none"):
        return False
    if emit == "all" and lane_extent(P) > EMIT_MAX_L:
        return False
    if cfg.N == 1 or cfg.depth == 1:
        return True
    if base & (base - 1):
        return False
    L = lane_extent(P)
    return cfg.depth * L * L * 4 <= _GROUP_MAT_BYTES


def spec_to_cfg(spec):
    """The one place a SamplerSpec (algo mp|pmp) maps onto the kernel's
    PMPConfig (``pmpx``'s rule): the stabilizer passes through so that
    :func:`supports` rejects what the kernel does not implement, and the
    selection is "all_first", the root path the kernel traces."""
    from pmpx_torch.samplers.pmp import PMPConfig

    return PMPConfig(
        N=spec.N,
        depth=spec.depth if spec.algo == "pmp" else 1,
        step_size=spec.step_size,
        trans_sigma=spec.trans_sigma,
        selection="all_first",
        stabilizer=spec.stabilizer,
    )


def chain_mode(cfg) -> str:
    """The kernel mode of cfg, chosen as ``pmpx``'s make_fused_chain
    chooses it: binary for N = 1, mp for depth 1, general otherwise."""
    return _mode_of(cfg.N, cfg.depth)


def _mode_of(N: int, depth: int) -> str:
    if N == 1:
        return "binary"
    if depth == 1:
        return "mp"
    return "general"


def trans_norm(target, cfg) -> float:
    """The pairwise log-K divisor: ``cfg.trans_normalize_by``, where 0
    means the target's dimension."""
    norm = cfg.trans_normalize_by
    return float(target.d) if norm == 0 else float(norm)


def suff_stats(xg: torch.Tensor, yg: torch.Tensor) -> torch.Tensor:
    """(sum x, sum y, sum x^2, sum y^2, sum xy) in f32 over padded grids."""
    return torch.stack(
        [xg.sum(), yg.sum(), (xg * xg).sum(), (yg * yg).sum(),
         (xg * yg).sum()]
    )


def ref_step(stats, theta, u1, u2, usel, *, depth, n_data, temper,
             step_size, mode="binary", N=1, trans_sigma=1.0,
             trans_norm=1.0):
    """One superstep of the plain version, in the given mode.

    stats (5,), theta (3,), u1 and u2 (3, P), usel a 0-d tensor.  Returns
    ``(Y (3, P), logA (P,), w (P,), cdf (P,), u, k)`` so that a caller
    can see where a selection fell.  The MTM distances of the mp and
    general walks are taken about theta (S = Y - theta), as the kernel
    takes them.
    """
    P = u1.shape[1]
    base = N + 1
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    eps = step_size * z
    node = torch.arange(P, device=theta.device)
    # Y[x] = theta + sum_i [digit_i(x) != 0] eps[x mod base^(i+1)]
    S = torch.zeros_like(eps)
    for i in range(depth):
        temp = base**i
        born = ((node // temp) % base) != 0
        S = S + torch.where(born, eps[:, node % (temp * base)],
                            torch.zeros_like(eps))
    Y = theta[:, None] + S
    b0, b1, sg = Y[0], Y[1], Y[2]
    sx, sy, sxx, syy, sxy = stats
    rss = (
        syy + n_data * b0 * b0 + b1 * b1 * sxx
        + 2.0 * b0 * b1 * sx - 2.0 * b0 * sy - 2.0 * b1 * sxy
    )
    s2 = torch.clamp(sg * sg, min=1e-30)
    logpi = temper * (
        -0.5 * n_data * (_LOG_2PI + torch.log(s2)) - rss / (2.0 * s2)
    )
    denom = 2.0 * trans_sigma * trans_sigma * trans_norm
    if mode == "binary":
        # Barker walk: log sigmoid(logpi[anc] - logpi[anc ^ 2^i])
        logA = torch.zeros_like(logpi)
        for i in range(depth):
            anc = node & (2 ** (i + 1) - 1)
            logA = logA + torch.nn.functional.logsigmoid(
                logpi[anc] - logpi[anc ^ (2**i)]
            )
    elif mode == "mp":
        # flat MTM (fused_chain.py:328-341): lw_j = logpi_j - sum_k
        # |S_j - S_k|^2 / denom = logpi_j - (P|S_j|^2 - 2 S_j.G + Q)/denom
        sq = (S * S).sum(0)
        G = S.sum(1)
        cross = (S * G[:, None]).sum(0)
        d2 = P * sq - 2.0 * cross + sq.sum()
        lw = logpi - d2 / denom
        m = lw.max()
        logA = lw - (m + torch.log(torch.exp(lw - m).sum()))
    elif mode == "general":
        # per-level sibling-group MTM weights (fused_chain.py:294-327):
        # group h = x mod temp of the first m = base*temp nodes, a
        # level-global shift zm and the group totals T_h
        sq = (S * S).sum(0)
        logA = torch.zeros_like(logpi)
        for i in range(depth):
            temp = base**i
            m = temp * base
            Sm = S[:, :m]
            G = Sm.reshape(3, base, temp).sum(1).repeat(1, base)
            q = sq[:m].reshape(base, temp).sum(0).repeat(base)
            gd2 = base * sq[:m] - 2.0 * (Sm * G).sum(0) + q
            lw = logpi[:m] - gd2 / denom
            zm = lw.max()
            T = torch.clamp(
                torch.exp(lw - zm).reshape(base, temp).sum(0), min=1e-30
            )
            logA = (logA + lw.repeat(P // m) - zm
                    - torch.log(T).repeat(P // temp))
    else:
        raise ValueError(f"unknown mode {mode!r}")
    w = torch.exp(logA - logA.max())
    cdf = torch.cumsum(w, dim=0)
    u = usel * w.sum()
    k = torch.clamp(torch.sum(cdf < u), max=P - 1)
    return Y, logA, w, cdf, u, k


def ref_emit(Y, w, cdf, ue):
    """The ``emit="all"`` draws of one superstep, from :func:`ref_step`'s
    positions ``Y`` (3, P), weights ``w`` and ``cdf``, and the slot
    uniforms ``ue`` (>= P entries, slot j at j).

    ``k[j] = min(#{l < P : cdf[l] < ue[j] * sum(w)}, P - 1)`` for every
    slot j < P (searchsorted side="left"; ``sum(w)`` is the reduction the
    root selection uses, not ``cdf[-1]``).  Returns ``(k (P,), sel (3, P),
    J)``: the draws, their states, and the within-step squared-jump sum
    ``J = sum_{j>=1} |sel[:, j] - sel[:, j-1]|^2``.
    """
    P = Y.shape[1]
    thr = ue[:P] * w.sum()
    k = torch.clamp((cdf[None, :] < thr[:, None]).sum(1), max=P - 1)
    sel = Y[:, k]
    d = sel[:, 1:] - sel[:, :-1]
    return k, sel, (d * d).sum()


def fused_chain_ref(xg, yg, theta, uin, *, P, depth, n_data, temper,
                    step_size, mode="binary", N=1, trans_sigma=1.0,
                    trans_norm=1.0, uemit=None):
    """Plain PyTorch version of :func:`chain_chunk` for one chain with
    injected uniforms: a step-by-step loop over the same 17-row layout.

    ``emit="root"`` (``uemit`` None): returns ``(trace (4, steps),
    theta_out (3,))``, trace rows (beta0, beta1, sigma, selected node).
    ``emit="all"`` (``uemit`` (steps, L)): returns ``(trace (8, steps),
    theta_out (3,), emit_b0 (steps, P))``, trace rows 0-2 the state (slot
    0's draw), 3 the jump sum, 4-6 the last slot's draw, 7 slot 0's node.
    """
    steps = uin.shape[0] // U_ROWS
    stats = suff_stats(xg, yg)
    emit_all = uemit is not None
    trace = torch.zeros((8 if emit_all else 4, steps), dtype=torch.float32,
                        device=xg.device)
    if emit_all:
        emit_b0 = torch.zeros((steps, P), dtype=torch.float32,
                              device=xg.device)
    for t in range(steps):
        base = t * U_ROWS
        Y, _, w, cdf, _, k = ref_step(
            stats, theta, uin[base:base + 3, :P], uin[base + 8:base + 11, :P],
            uin[base + 16, 0], depth=depth, n_data=n_data, temper=temper,
            step_size=step_size, mode=mode, N=N, trans_sigma=trans_sigma,
            trans_norm=trans_norm,
        )
        if emit_all:
            ks, sel, J = ref_emit(Y, w, cdf, uemit[t])
            theta = sel[:, 0].contiguous()
            trace[:3, t] = theta
            trace[3, t] = J
            trace[4:7, t] = sel[:, -1]
            trace[7, t] = ks[0].float()
            emit_b0[t] = sel[0]
        else:
            theta = Y[:, k].contiguous()
            trace[:3, t] = theta
            trace[3, t] = k.float()
    if emit_all:
        return trace, theta, emit_b0
    return trace, theta


def _replay_steps(stats, prev, uin, P, model):
    """:func:`ref_step` for T supersteps at once: superstep t from state
    ``prev[t]`` (T, 3) on its 17 rows of ``uin`` (T*17, L).  Returns
    ``(Y (T, 3, P), cdf (T, P), u (T,), k (T,))``."""
    u = uin.reshape(-1, U_ROWS, uin.shape[-1])
    step = torch.func.vmap(
        lambda th, u1, u2, us: ref_step(stats, th, u1, u2, us, **model))
    Y, _, _, cdf, uu, k = step(prev, u[:, 0:3, :P], u[:, 8:11, :P],
                               u[:, 16, 0])
    return Y, cdf, uu, k


def _misses(t_miss, k, kk, uu, cdf):
    """``(step, plain node, kernel node, u, cdf[k-1], cdf[k])`` of each
    superstep in ``t_miss`` (CPU tensors)."""
    out = []
    for t in t_miss.tolist():
        kt = int(k[t])
        lo = cdf[t, kt - 1].item() if kt > 0 else 0.0
        out.append((t, kt, int(kk[t]), uu[t].item(), lo, cdf[t, kt].item()))
    return out


def replay_against_plain(xg, yg, theta0, uin, *, P, **model):
    """Hold :func:`chain_chunk` against its plain version superstep by
    superstep.

    Runs one launch per chunk of ``uin`` (chunks, steps*17, L), each from
    the state the previous one left, then replays every superstep with
    :func:`ref_step` from the kernel's own previous state, so that one
    disagreement does not derail the rest.  ``model`` holds the keyword
    arguments of :func:`chain_chunk` besides ``steps`` and ``P``.
    Returns ``(trace (4, chunks*steps) on the CPU, theta_out, agree,
    max_err, misses)``: the selections both pick, the max |error| of the
    state where they do, and ``(step, plain node, kernel node, u,
    cdf[k-1], cdf[k])`` for each superstep where they do not.
    """
    chunks = uin.shape[0]
    steps = uin.shape[1] // U_ROWS
    theta = theta0
    parts = []
    for c in range(chunks):
        tr, theta = chain_chunk(xg, yg, theta, steps=steps, P=P, uin=uin[c],
                                **model)
        parts.append(tr)
    ktrace = torch.cat(parts, dim=1).cpu()
    prev = torch.cat([theta0.cpu()[None], ktrace[:3, :-1].T])
    Y, cdf, uu, k = _replay_steps(suff_stats(xg, yg),
                                  prev.to(theta0.device),
                                  uin.reshape(-1, uin.shape[-1]), P, model)
    Y, cdf, uu, k = Y.cpu(), cdf.cpu(), uu.cpu(), k.cpu()
    kk = ktrace[3].long()
    same = k == kk
    T = steps * chunks
    err = (Y[torch.arange(T), :, k] - ktrace[:3].T).abs().amax(1)
    max_err = float(err[same].max()) if bool(same.any()) else 0.0
    misses = _misses(torch.nonzero(~same).flatten(), k, kk, uu, cdf)
    return ktrace, theta, int(same.sum()), max_err, misses


def replay_roots_against_plain(xg, yg, theta0, uin, roots, *, P, **model):
    """Hold a chain's states, as a runner returns them, against the plain
    version superstep by superstep.

    ``roots`` (T, 3) are the states a chain reached from ``theta0`` (3,)
    on the uniforms ``uin`` (T*17, L); for a farm, one chain of
    :func:`pmpx_torch.parallel.chains.make_chain_farm_fused`'s runner fed
    ``uin``.  Each superstep is replayed with :func:`ref_step` from the
    chain's own previous state; the chain's selection is the node whose
    plain position is nearest its state.  Returns ``(agree, max_err,
    misses)`` as :func:`replay_against_plain` counts them.
    """
    roots = roots.cpu()
    prev = torch.cat([theta0.cpu()[None], roots[:-1]])
    Y, cdf, uu, k = _replay_steps(suff_stats(xg, yg), prev.to(xg.device),
                                  uin, P, model)
    Y, cdf, uu, k = Y.cpu(), cdf.cpu(), uu.cpu(), k.cpu()
    dist = (Y - roots[:, :, None]).abs().amax(1)  # (T, P)
    kk = dist.argmin(1)
    same = k == kk
    err = dist[torch.arange(len(k)), k]
    max_err = float(err[same].max()) if bool(same.any()) else 0.0
    misses = _misses(torch.nonzero(~same).flatten(), k, kk, uu, cdf)
    return int(same.sum()), max_err, misses


def replay_emit_against_plain(xg, yg, theta0, uin, uemit, *, P, **model):
    """Hold :func:`chain_chunk` with ``emit="all"`` against its plain
    version superstep by superstep, as :func:`replay_against_plain` does
    for ``emit="root"``.

    ``uin`` (chunks, steps*17, L) and ``uemit`` (chunks, steps, L): one
    launch per chunk, each from the state the previous one left; then
    every superstep is replayed with :func:`ref_step` and :func:`ref_emit`
    from the kernel's own previous state.  The kernel's draw of slot j is
    the node whose plain position has the nearest b0 to the kernel's
    emitted one.  Returns a dict: ``trace`` (8, T) and ``emit_b0`` (T, P)
    of the kernel on the CPU, ``theta``; ``slots`` and ``slots_agree``
    (slot draws in all, and equal); ``state_err``, the max |error| of the
    state (rows 0-2) and of the last slot's (rows 4-6) where slot 0's and
    slot P-1's draws agree; ``jump_err``, the max of |J_kernel - J_plain|
    / max(1, J_plain) over the supersteps where every slot agrees;
    ``b0_root_equal``, whether emitted slot 0 is bit-equal to the state's
    b0; ``misses``, (step, slot, plain node, kernel node) of each slot
    that disagrees.
    """
    chunks = uin.shape[0]
    steps = uin.shape[1] // U_ROWS
    theta = theta0
    parts, b0s = [], []
    for c in range(chunks):
        tr, theta, eb = chain_chunk(xg, yg, theta, steps=steps, P=P,
                                    uin=uin[c], uemit=uemit[c], emit="all",
                                    **model)
        parts.append(tr)
        b0s.append(eb)
    ktrace = torch.cat(parts, dim=1).cpu()
    kb0 = torch.cat(b0s, dim=0).cpu()
    stats = suff_stats(xg, yg)
    prev = theta0
    out = dict(trace=ktrace, emit_b0=kb0, theta=theta, slots=0,
               slots_agree=0, state_err=0.0, jump_err=0.0, misses=[],
               b0_root_equal=bool(torch.equal(kb0[:, 0], ktrace[0])))
    for t in range(steps * chunks):
        c, tt = divmod(t, steps)
        b = tt * U_ROWS
        Y, _, w, cdf, _, _ = ref_step(
            stats, prev, uin[c, b:b + 3, :P], uin[c, b + 8:b + 11, :P],
            uin[c, b + 16, 0], **model)
        ks, sel, J = ref_emit(Y, w, cdf, uemit[c, tt])
        Yc, ks = Y.cpu(), ks.cpu()
        # the kernel's draws: the node of nearest b0
        kk = (Yc[0][None, :] - kb0[t][:, None]).abs().argmin(1)
        same = kk == ks
        out["slots"] += P
        out["slots_agree"] += int(same.sum())
        for j in torch.nonzero(~same).flatten().tolist():
            out["misses"].append((t, j, int(ks[j]), int(kk[j])))
        sel = sel.cpu()
        if same[0]:
            err = (sel[:, 0] - ktrace[:3, t]).abs().max().item()
            out["state_err"] = max(out["state_err"], err)
        if same[-1]:
            err = (sel[:, -1] - ktrace[4:7, t]).abs().max().item()
            out["state_err"] = max(out["state_err"], err)
        if bool(same.all()):
            Jp = float(J)
            err = abs(ktrace[3, t].item() - Jp) / max(1.0, Jp)
            out["jump_err"] = max(out["jump_err"], err)
        prev = ktrace[:3, t].to(theta0.device).contiguous()
    return out


def _check_mode(mode, P, depth, N):
    if mode not in KERNEL_NAME:
        raise ValueError(f"unknown mode {mode!r}")
    base = N + 1
    ok = (
        N >= 1 and depth >= 1 and 2 <= P <= _MAX_P and base**depth == P
        and mode == _mode_of(N, depth)
        and (mode != "general" or base & (base - 1) == 0)
    )
    if not ok:
        raise ValueError(
            f"mode {mode!r} does not take N={N}, depth={depth}, P={P} "
            f"(binary: N = 1; mp: depth 1; general: a power-of-two base "
            f"N + 1 and depth > 1; P = (N + 1)**depth <= {_MAX_P})"
        )


def _check(xg, yg, theta, steps, P, seed, uin, emit, uemit):
    dev = xg.device
    for name, t in (("xg", xg), ("yg", yg), ("theta", theta)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, xg on {dev}")
    if yg.shape != xg.shape or theta.dim() not in (1, 2) \
            or theta.shape[-1] != 3 or theta.shape[0] < 1:
        raise ValueError(
            f"want matching grids and theta (3,) or (C, 3), got "
            f"{tuple(xg.shape)}, {tuple(yg.shape)}, {tuple(theta.shape)}"
        )
    farm = theta.dim() == 2
    C = theta.shape[0] if farm else 1
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if emit not in ("root", "all"):
        raise ValueError(f"unknown emit {emit!r}")
    L = lane_extent(P)
    if emit == "all":
        if farm:
            raise ValueError("emit='all' runs one chain (theta (3,))")
        if L > EMIT_MAX_L:
            raise ValueError(f"emit='all' takes P <= {EMIT_MAX_L}, got {P}")
    if uin is not None:
        want = ((C,) if farm else ()) + (steps * U_ROWS, L)
        if uin.dtype != torch.float32 or not uin.is_contiguous():
            raise ValueError("uin must be contiguous float32")
        if uin.device != dev or tuple(uin.shape) != want:
            raise ValueError(
                f"uin must be {want} on {dev}, got {tuple(uin.shape)} on "
                f"{uin.device}"
            )
        if emit == "all" and (
                uemit is None or uemit.dtype != torch.float32
                or not uemit.is_contiguous() or uemit.device != dev
                or tuple(uemit.shape) != (steps, L)):
            raise ValueError(f"emit='all' with uin needs uemit: a contiguous "
                             f"float32 ({steps}, {L}) on {dev}")
    elif (seed is None or seed.dtype != torch.int32 or seed.device != dev
          or seed.numel() != C or not seed.is_contiguous()):
        raise ValueError(f"rng='kernel' needs seed: {C} contiguous int32 on "
                         f"xg's device")
    if uin is None and uemit is not None:
        raise ValueError("uemit goes with uin (rng='input')")


def chain_chunk(
    xg: torch.Tensor,
    yg: torch.Tensor,
    theta: torch.Tensor,
    *,
    steps: int,
    P: int,
    depth: int,
    n_data: float,
    temper: float,
    step_size: float,
    mode: str = "binary",
    N: int = 1,
    trans_sigma: float = 1.0,
    trans_norm: float = 1.0,
    seed: Optional[torch.Tensor] = None,
    uin: Optional[torch.Tensor] = None,
    emit: str = "root",
    uemit: Optional[torch.Tensor] = None,
):
    """``steps`` supersteps from ``theta`` in ``mode`` (``binary``, ``mp``
    or ``general``; P = (N + 1)**depth): of one chain for theta (3,), or of
    a farm of C independent chains, one block each, for theta (C, 3).

    xg, yg : zero-padded data grids (any shape; summed flat), shared by
        the chains of a farm.
    trans_sigma, trans_norm : the MTM transition density of mp and general
        (ignored by binary, whose symmetric K cancels).
    seed : (1,) or (C,) int32, the Philox keys of ``rng="kernel"``; or
    uin : (steps*17, L), or (C, steps*17, L), injected uniforms in (0, 1].
    emit : ``"root"``, or ``"all"`` (one chain, P <= 512) with
    uemit : (steps, L) slot uniforms when ``uin`` is given.

    ``emit="root"`` returns ``(trace, theta_out)``: trace (4, steps), or
    (C, 4, steps) for a farm, rows (beta0, beta1, sigma, selected node)
    after each superstep; theta_out (3,) or (C, 3).  ``emit="all"`` returns
    ``(trace (8, steps), theta_out (3,), emit_b0 (steps, P))`` as
    :func:`fused_chain_ref` lays them out.  Chain c of a farm is
    bit-identical to a one-chain call with its seed (or uniforms) and
    theta.
    """
    _check_mode(mode, P, depth, N)
    _check(xg, yg, theta, steps, P, seed, uin, emit, uemit)
    dev = xg.device
    farm = theta.dim() == 2
    emit_all = emit == "all"
    model = dict(depth=depth, n_data=n_data, temper=temper,
                 step_size=step_size, mode=mode, N=N,
                 trans_sigma=trans_sigma, trans_norm=trans_norm)
    if dev.type == "cpu":
        if uin is None:
            raise ValueError("on the CPU the chain needs injected uniforms")
        if farm:
            runs = [fused_chain_ref(xg, yg, theta[c], uin[c], P=P, **model)
                    for c in range(theta.shape[0])]
            return (torch.stack([r[0] for r in runs]),
                    torch.stack([r[1] for r in runs]))
        return fused_chain_ref(xg, yg, theta, uin, P=P, uemit=uemit, **model)
    if dev.type != "cuda":
        raise ValueError(f"chain_chunk runs on cuda or cpu, not {dev}")
    lib = _build.load().lib
    C = theta.shape[0] if farm else 1
    rows = 8 if emit_all else 4
    trace = torch.empty(((C,) if farm else ()) + (rows, steps), device=dev)
    theta_out = torch.empty_like(theta)
    emit_b0 = torch.empty((steps, P), device=dev) if emit_all else None
    base = 2 if mode == "binary" else N + 1
    denom = float(2.0 * trans_sigma * trans_sigma * trans_norm)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pmpx_fused_chain(
            _MODE_ID[mode], int(emit_all), C, ptr(seed), theta.data_ptr(),
            xg.data_ptr(), yg.data_ptr(), xg.numel(), ptr(uin), ptr(uemit),
            trace.data_ptr(), theta_out.data_ptr(), ptr(emit_b0), steps, P,
            lane_extent(P), base, depth, float(n_data), float(temper),
            float(step_size), denom, stream,
        )
    if farm:
        name = FARM_KERNEL
    else:
        name = (KERNEL_NAME_ALL if emit_all else KERNEL_NAME)[mode]
    _build.check(err, name)
    launches[name] += 1
    if emit_all:
        return trace, theta_out, emit_b0
    return trace, theta_out


def chain_consts(target, cfg) -> dict:
    """The keyword arguments of :func:`chain_chunk` (all but ``steps`` and
    the uniforms) for cfg's sampler over ``target``."""
    return dict(
        P=(cfg.N + 1) ** cfg.depth, depth=cfg.depth, n_data=float(target.n),
        temper=float(target.temper), step_size=float(cfg.step_size),
        mode=chain_mode(cfg), N=cfg.N, trans_sigma=float(cfg.trans_sigma),
        trans_norm=trans_norm(target, cfg),
    )


def make_fused_chain(target, cfg, *, chunk: int = 512, rng: str = "kernel",
                     emit: str = "root"):
    """Build ``run(generator, theta0, num_steps, *, uin=None, uemit=None)``.

    ``target`` is a :class:`pmpx_torch.targets.BayesLinReg` and ``cfg`` a
    PMPConfig with ``supports(cfg, emit)``; its mode is
    :func:`chain_mode`.  The chain runs ``ceil(num_steps / chunk)``
    launches of ``chunk`` supersteps; each launch starts from the state
    the previous one left on the device, so the host never waits between
    launches.  ``uin`` (n_chunks, chunk*17, L) and, for ``emit="all"``,
    ``uemit`` (n_chunks, chunk, L) replace the uniforms of
    ``rng="input"``.

    ``emit="root"``: ``run`` returns the chain state after each superstep,
    (num_steps, 3).  ``emit="all"``: ``run`` returns ``pmpx``'s dict,
    ``root`` (num_steps, 3) the chain path (slot 0's draw), ``jumps``
    (num_steps,) the within-step squared-jump sums, ``last`` (num_steps,
    3) the last slot's draw, and ``emit_b0`` (P, num_steps) every slot's
    b0.
    """
    if not supports(cfg, emit):
        raise ValueError(f"fused chain does not support {cfg} emit={emit}")
    if rng not in ("kernel", "input"):
        raise ValueError(f"unknown rng {rng!r}")
    consts = chain_consts(target, cfg)
    L = lane_extent(consts["P"])
    xg, yg = target.x2d, target.y2d
    dev = xg.device
    emit_all = emit == "all"

    def run(generator: torch.Generator, theta0: torch.Tensor,
            num_steps: int, *, uin: Optional[torch.Tensor] = None,
            uemit: Optional[torch.Tensor] = None):
        n_chunks = -(-num_steps // chunk)
        if (uin is not None or uemit is not None) and rng != "input":
            raise ValueError("uin and uemit replace the uniforms of "
                             "rng='input'")
        kernel_rng = rng == "kernel" and dev.type == "cuda"
        if kernel_rng:
            seeds = torch.randint(
                0, 2**31 - 1, (n_chunks, 1), generator=generator,
                device=dev, dtype=torch.int32,
            )
        theta = theta0.to(device=dev, dtype=torch.float32).contiguous()
        parts = []
        for c in range(n_chunks):
            if kernel_rng:
                kw = dict(seed=seeds[c])
            elif uin is not None:
                kw = dict(uin=uin[c])
                if emit_all:
                    kw["uemit"] = uemit[c]
            else:
                kw = dict(uin=1.0 - torch.rand(
                    (chunk * U_ROWS, L), generator=generator, device=dev))
                if emit_all:
                    kw["uemit"] = 1.0 - torch.rand(
                        (chunk, L), generator=generator, device=dev)
            out = chain_chunk(xg, yg, theta, steps=chunk, emit=emit, **kw,
                              **consts)
            theta = out[1]
            parts.append(out[0] if not emit_all else (out[0], out[2]))
        if not emit_all:
            return torch.cat([tr[:3] for tr in parts], dim=1).T[:num_steps]
        meta = torch.cat([m for m, _ in parts], dim=1)[:, :num_steps]
        return {
            "root": meta[:3].T,
            "jumps": meta[3],
            "last": meta[4:7].T,
            "emit_b0": torch.cat([b for _, b in parts], dim=0)[
                :num_steps].T,
        }

    return run
