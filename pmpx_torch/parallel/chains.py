"""Several chains on one card (port of ``pmpx/parallel/chains.py``'s
single-device parts).

``run_chains_vmapped``: ``pmpx`` vmaps a scanned chain over C keys.  Here
a superstep takes a batch of states (C, d) and advances every chain in one
pass (:mod:`pmpx_torch.samplers.pmp`, :mod:`pmpx_torch.samplers.mh`): one
draw of the batch's noise, one ``batch_log_prob`` call over all C*P
states (on the sweep, one ``linreg_rss`` launch), and each chain
resampled from its own weights.  ``torch.func.vmap`` would give no
per-chain generator and no batching rule for the ctypes-bound kernels.
The batch shares one ``torch.Generator``: its chains have the law of
``pmpx``'s, but chain c is not reproducible on its own.

The fused farm: ``pmpx`` runs C chains through ``lax.map`` over its fused
kernel, one after another on each device of a ``chains`` mesh axis.  Here
one launch of the fused chain kernel runs all C chains, one thread block
each (:func:`pmpx_torch.kernels.fused_chain.chain_chunk` with theta (C,
3)), so that the chains fill the card's SMs instead of one.  Chain c is
bit-identical to a single chain of
:func:`~pmpx_torch.kernels.fused_chain.make_fused_chain` run from chain
c's generator and theta0, as ``pmpx`` asserts for its farm.

Not ported yet: the mesh and ``shard_map`` parts (ROADMAP §1 item 20).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from pmpx_torch._device import resolve_device
from pmpx_torch.kernels import fused_chain as fc
from pmpx_torch.samplers.base import run_chain

__all__ = ["chain_generators", "make_chain_farm_fused", "run_chains_fused",
           "run_chains_vmapped"]


def _chain_major(recs):
    """Records stacked (steps, C, ...) -> (C, steps, ...), through dicts
    and tuples."""
    if isinstance(recs, dict):
        return {k: _chain_major(v) for k, v in recs.items()}
    if isinstance(recs, tuple):
        return tuple(_chain_major(v) for v in recs)
    return recs.transpose(0, 1)


def run_chains_vmapped(superstep: Callable, generator: torch.Generator,
                       theta0: torch.Tensor, num_steps: int,
                       collect: Optional[Callable] = None):
    """C chains of a batched superstep (the tree samplers and MH take a
    (C, d) state) from ``theta0`` (C, d), all drawing from
    ``generator``.  Returns ``(final (C, d), records stacked as (C,
    steps, ...))``, as ``pmpx``'s does."""
    final, recs = run_chain(superstep, generator, theta0, num_steps,
                            collect=collect)
    return final, _chain_major(recs)


def chain_generators(seed: int, chains: int, device=None
                     ) -> list[torch.Generator]:
    """One ``torch.Generator`` per chain on ``device``, chain c seeded from
    (seed, c) through NumPy's ``SeedSequence``: the port's counterpart of
    ``jax.random.split(key, chains)``."""
    dev = resolve_device(device)
    gens = []
    for c in range(chains):
        g = torch.Generator(device=dev)
        g.manual_seed(int(np.random.SeedSequence([seed, c]).generate_state(
            1)[0]))
        gens.append(g)
    return gens


def make_chain_farm_fused(target, cfg, num_steps: int, *, chunk: int = 512,
                          rng: str = "kernel") -> Callable:
    """Build ``run(generators, theta0, *, uin=None) -> roots (C, num_steps,
    3)``: C chains of cfg's fused sampler over ``target`` (a
    :class:`pmpx_torch.targets.BayesLinReg`), ``ceil(num_steps / chunk)``
    launches of all C chains at once.

    ``generators``: C ``torch.Generator`` on the target's device, one per
    chain; chain c draws its per-chunk seeds (or, with ``rng="input"`` and
    on the CPU, its uniforms) from ``generators[c]`` exactly as a single
    chain does.  ``theta0``: (C, 3).  ``uin`` (n_chunks, C, chunk*17, L)
    replaces the uniforms of ``rng="input"``.  ``emit="root"`` only:
    ``pmpx`` refuses the per-slot emission with several chains too.
    """
    if not fc.supports(cfg, "root"):
        raise ValueError(f"fused chain does not support {cfg}")
    if rng not in ("kernel", "input"):
        raise ValueError(f"unknown rng {rng!r}")
    consts = fc.chain_consts(target, cfg)
    L = fc.lane_extent(consts["P"])
    xg, yg = target.x2d, target.y2d
    dev = xg.device

    def run(generators: Sequence[torch.Generator], theta0: torch.Tensor, *,
            uin: Optional[torch.Tensor] = None) -> torch.Tensor:
        theta = theta0.to(device=dev, dtype=torch.float32).contiguous()
        C = len(generators)
        if theta.shape != (C, 3):
            raise ValueError(f"{C} generators need theta0 ({C}, 3), got "
                             f"{tuple(theta.shape)}")
        if uin is not None and rng != "input":
            raise ValueError("uin replaces the uniforms of rng='input'")
        n_chunks = -(-num_steps // chunk)
        kernel_rng = rng == "kernel" and dev.type == "cuda"
        if kernel_rng:
            seeds = torch.cat([
                torch.randint(0, 2**31 - 1, (n_chunks, 1), generator=g,
                              device=dev, dtype=torch.int32)
                for g in generators], dim=1)
        parts = []
        for c in range(n_chunks):
            if kernel_rng:
                kw = dict(seed=seeds[c])
            elif uin is not None:
                kw = dict(uin=uin[c])
            else:
                kw = dict(uin=torch.stack([
                    1.0 - torch.rand((chunk * fc.U_ROWS, L), generator=g,
                                     device=dev)
                    for g in generators]))
            tr, theta = fc.chain_chunk(xg, yg, theta, steps=chunk, **kw,
                                       **consts)
            parts.append(tr[:, :3])
        return torch.cat(parts, dim=2)[:, :, :num_steps].transpose(1, 2)

    return run


def run_chains_fused(target, cfg, generators: Sequence[torch.Generator],
                     theta0: torch.Tensor, num_steps: int, *,
                     chunk: int = 512, rng: str = "kernel") -> torch.Tensor:
    """One call of :func:`make_chain_farm_fused`'s runner: the
    (C, num_steps, 3) roots of C chains."""
    farm = make_chain_farm_fused(target, cfg, num_steps, chunk=chunk,
                                 rng=rng)
    return farm(generators, theta0)
