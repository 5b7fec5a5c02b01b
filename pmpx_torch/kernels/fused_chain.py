"""Whole chunks of an MP/PMP chain over Bayesian linreg in one launch
(port of ``pmpx/kernels/fused_chain.py`` with ``emit="root"``).

Three modes, chosen from the config as ``pmpx`` chooses them
(:func:`chain_mode`): ``binary`` (N = 1), ``mp`` (flat MTM, depth 1) and
``general`` ((N, depth) trees with a power-of-two base N + 1).
:func:`chain_chunk` runs ``steps`` supersteps of one chain: the mode's CUDA
kernel in ``csrc/fused_chain.cu`` for CUDA tensors, its plain version
:func:`fused_chain_ref` for CPU tensors.  :func:`make_fused_chain` builds
the chain runner over chunks, the counterpart of ``pmpx``'s.

Uniforms: ``rng="kernel"`` draws them in the kernel from a Philox stream
keyed by one seed per chunk, the seeds drawn from the caller's
``torch.Generator``; ``rng="input"`` takes 17 rows of L lanes per
superstep (rows 0-7 u1, 8-15 u2 for Box-Muller, of which rows 0-2 and lanes
< P are used; row 16 lane 0 the selection uniform), all in (0, 1] and laid
out as ``pmpx``'s, so both packages can be fed the same numbers.  On the
CPU there is no in-kernel generator, so ``rng="kernel"`` draws input
uniforms from the generator instead, as ``pmpx`` does off the TPU.
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
    "replay_against_plain",
    "suff_stats",
    "lane_extent",
    "KERNEL_NAME",
    "U_ROWS",
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
# the launch counter (pmpx_torch.kernels.launches) of each mode's kernel
KERNEL_NAME = {
    "binary": "fused_chain",
    "mp": "fused_chain_mp",
    "general": "fused_chain_general",
}


def lane_extent(P: int) -> int:
    """Threads (lanes) the kernel runs for P nodes: P rounded up to 128."""
    return -(-max(P, _LANES) // _LANES) * _LANES


def supports(cfg, emit: str = "root") -> bool:
    """Whether this port implements cfg's sampler exactly: what
    ``pmpx.kernels.fused_chain.supports(cfg, "root")`` answers (P <= 1024,
    stabilizer "none"; binary trees and flat MP of any size, general
    (N, depth) trees with a power-of-two base whose group matrices would
    fit pmpx's 8 MiB).  ``emit="all"`` is not ported: False."""
    if emit != "root":
        return False
    base = cfg.N + 1
    P = base**cfg.depth
    if not (P <= _MAX_P and cfg.stabilizer == "none"):
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


def fused_chain_ref(xg, yg, theta, uin, *, P, depth, n_data, temper,
                    step_size, mode="binary", N=1, trans_sigma=1.0,
                    trans_norm=1.0):
    """Plain PyTorch version of :func:`chain_chunk` with injected uniforms:
    a step-by-step loop over the same 17-row layout.  Returns
    ``(trace (4, steps), theta_out (3,))``, trace rows (beta0, beta1,
    sigma, selected node)."""
    steps = uin.shape[0] // U_ROWS
    stats = suff_stats(xg, yg)
    trace = torch.zeros((4, steps), dtype=torch.float32, device=xg.device)
    for t in range(steps):
        base = t * U_ROWS
        Y, _, _, _, _, k = ref_step(
            stats, theta, uin[base:base + 3, :P], uin[base + 8:base + 11, :P],
            uin[base + 16, 0], depth=depth, n_data=n_data, temper=temper,
            step_size=step_size, mode=mode, N=N, trans_sigma=trans_sigma,
            trans_norm=trans_norm,
        )
        theta = Y[:, k].contiguous()
        trace[:3, t] = theta
        trace[3, t] = k.float()
    return trace, theta


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
    stats = suff_stats(xg, yg)
    prev = theta0
    agree, max_err, misses = 0, 0.0, []
    for t in range(steps * chunks):
        c, tt = divmod(t, steps)
        b = tt * U_ROWS
        Y, _, _, cdf, u, k = ref_step(
            stats, prev, uin[c, b:b + 3, :P], uin[c, b + 8:b + 11, :P],
            uin[c, b + 16, 0], **model)
        k, kk = int(k), int(ktrace[3, t])
        if k == kk:
            agree += 1
            err = (Y[:, k].cpu() - ktrace[:3, t]).abs().max().item()
            max_err = max(max_err, err)
        else:
            lo = cdf[k - 1].item() if k > 0 else 0.0
            misses.append((t, k, kk, u.item(), lo, cdf[k].item()))
        prev = ktrace[:3, t].to(theta0.device).contiguous()
    return ktrace, theta, agree, max_err, misses


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


def _check(xg, yg, theta, steps, P, seed, uin):
    dev = xg.device
    for name, t in (("xg", xg), ("yg", yg), ("theta", theta)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, xg on {dev}")
    if yg.shape != xg.shape or theta.shape != (3,):
        raise ValueError(
            f"want matching grids and theta (3,), got {tuple(xg.shape)}, "
            f"{tuple(yg.shape)}, {tuple(theta.shape)}"
        )
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    L = lane_extent(P)
    if uin is not None:
        if uin.dtype != torch.float32 or not uin.is_contiguous():
            raise ValueError("uin must be contiguous float32")
        if uin.device != dev or uin.shape != (steps * U_ROWS, L):
            raise ValueError(
                f"uin must be ({steps * U_ROWS}, {L}) on {dev}, got "
                f"{tuple(uin.shape)} on {uin.device}"
            )
    elif (seed is None or seed.dtype != torch.int32 or seed.device != dev
          or seed.numel() != 1):
        raise ValueError("rng='kernel' needs seed: a (1,) int32 on xg's "
                         "device")


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
):
    """``steps`` supersteps of one chain from ``theta`` (3,) in ``mode``
    (``binary``, ``mp`` or ``general``; P = (N + 1)**depth).

    xg, yg : zero-padded data grids (any shape; summed flat).
    trans_sigma, trans_norm : the MTM transition density of mp and general
        (ignored by binary, whose symmetric K cancels).
    seed : (1,) int32, the Philox key of ``rng="kernel"``; or
    uin : (steps*17, L) injected uniforms in (0, 1].
    Returns ``(trace (4, steps), theta_out (3,))``: trace rows are
    (beta0, beta1, sigma, selected node) after each superstep.
    """
    _check_mode(mode, P, depth, N)
    _check(xg, yg, theta, steps, P, seed, uin)
    dev = xg.device
    model = dict(depth=depth, n_data=n_data, temper=temper,
                 step_size=step_size, mode=mode, N=N,
                 trans_sigma=trans_sigma, trans_norm=trans_norm)
    if dev.type == "cpu":
        if uin is None:
            raise ValueError("on the CPU the chain needs injected uniforms")
        return fused_chain_ref(xg, yg, theta, uin, P=P, **model)
    if dev.type != "cuda":
        raise ValueError(f"chain_chunk runs on cuda or cpu, not {dev}")
    lib = _build.load().lib
    trace = torch.empty((4, steps), device=dev)
    theta_out = torch.empty((3,), device=dev)
    denom = float(2.0 * trans_sigma * trans_sigma * trans_norm)
    common = (
        None if seed is None else seed.data_ptr(),
        theta.data_ptr(), xg.data_ptr(), yg.data_ptr(), xg.numel(),
        None if uin is None else uin.data_ptr(),
        trace.data_ptr(), theta_out.data_ptr(), steps, P, lane_extent(P),
    )
    lik = (float(n_data), float(temper), float(step_size))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if mode == "binary":
            err = lib.pmpx_fused_chain_binary(*common, depth, *lik, stream)
        elif mode == "mp":
            err = lib.pmpx_fused_chain_mp(*common, *lik, denom, stream)
        else:
            err = lib.pmpx_fused_chain_general(*common, N + 1, depth, *lik,
                                               denom, stream)
    name = KERNEL_NAME[mode]
    _build.check(err, name)
    launches[name] += 1
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
    """Build ``run(generator, theta0, num_steps, *, uin=None) -> trace
    (num_steps, 3)``, the chain state after each superstep.

    ``target`` is a :class:`pmpx_torch.targets.BayesLinReg` and ``cfg`` a
    PMPConfig with ``supports(cfg, emit)``; its mode is
    :func:`chain_mode`.  The chain runs ``ceil(num_steps / chunk)``
    launches of ``chunk`` supersteps; each launch starts from the state
    the previous one left on the device, so the host never waits between
    launches.  ``uin`` (n_chunks, chunk*17, L) replaces the uniforms of
    ``rng="input"``.
    """
    if not supports(cfg, emit):
        raise ValueError(f"fused chain does not support {cfg} emit={emit}")
    if rng not in ("kernel", "input"):
        raise ValueError(f"unknown rng {rng!r}")
    consts = chain_consts(target, cfg)
    L = lane_extent(consts["P"])
    xg, yg = target.x2d, target.y2d
    dev = xg.device

    def run(generator: torch.Generator, theta0: torch.Tensor,
            num_steps: int, *, uin: Optional[torch.Tensor] = None):
        n_chunks = -(-num_steps // chunk)
        if uin is not None and rng != "input":
            raise ValueError("uin replaces the uniforms of rng='input'")
        kernel_rng = rng == "kernel" and dev.type == "cuda"
        if kernel_rng:
            seeds = torch.randint(
                0, 2**31 - 1, (n_chunks, 1), generator=generator,
                device=dev, dtype=torch.int32,
            )
        theta = theta0.to(device=dev, dtype=torch.float32).contiguous()
        traces = []
        for c in range(n_chunks):
            if kernel_rng:
                kw = dict(seed=seeds[c])
            elif uin is not None:
                kw = dict(uin=uin[c])
            else:
                kw = dict(uin=1.0 - torch.rand(
                    (chunk * U_ROWS, L), generator=generator, device=dev
                ))
            tr, theta = chain_chunk(xg, yg, theta, steps=chunk, **kw,
                                    **consts)
            traces.append(tr[:3])
        return torch.cat(traces, dim=1).T[:num_steps]

    return run
