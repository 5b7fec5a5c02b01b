"""Several chains at once, on one card or over the ``chains`` axis of a
mesh (port of ``pmpx/parallel/chains.py``).

``run_chains_vmapped``: ``pmpx`` vmaps a scanned chain over C keys.  Here
a superstep takes a batch of states (C, d) and advances every chain in one
pass (:mod:`pmpx_torch.samplers.pmp`, :mod:`pmpx_torch.samplers.mh`): one
draw of the batch's noise, one ``batch_log_prob`` call over all C*P
states (on the sweep, one ``linreg_rss`` launch), and each chain
resampled from its own weights.  ``torch.func.vmap`` would give no
per-chain generator and no batching rule for the ctypes-bound kernels.
The batch shares one ``torch.Generator``: its chains have the law of
``pmpx``'s, but chain c is not reproducible on its own.

``run_chains_sharded`` and ``run_chains_data_sharded``: ``pmpx``
``shard_map``s the vmapped chains over the ``chains`` mesh axis.  Here
each rank of that axis runs its contiguous block of C/W chains as one
batch, and the final states and records are gathered back in chain order
on every rank.  A generator cannot cross processes, so these take a seed:
rank r's block draws from a generator seeded from (seed, r), the scheme
of :func:`chain_generators`.  The seed depends on the chains coordinate
alone, so every rank of one data or tree group draws the same noise and
their resampling decisions agree with no further collective.  A run of C
chains over W ranks is not bit-equal to one over W' ranks (another
grouping of the chains' noise); the law is the same.

The fused farm: ``pmpx`` runs C chains through ``lax.map`` over its fused
kernel, one after another on each device of a ``chains`` mesh axis.  Here
one launch of the fused chain kernel runs a rank's chains, one thread
block each, so that the chains fill the card's SMs instead of one; with a
mesh, each chains-rank launches its block and the roots are gathered back
in chain order.  The farm and
:func:`~pmpx_torch.kernels.fused_chain.make_fused_chain` run the same
chunk loop (``fused_chain._run_chunks``), which draws chain c's seeds or
uniforms from chain c's generator alone, so chain c is bit-identical to a
single chain run from that generator and theta0, as ``pmpx`` asserts for
its farm, whatever the mesh.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from pmpx_torch._device import resolve_device
from pmpx_torch.kernels import fused_chain as fc
from pmpx_torch.parallel.mesh import AXIS_CHAINS, AXIS_DATA, all_gather_cat
from pmpx_torch.profiling import span
from pmpx_torch.samplers.base import run_chain

__all__ = ["chain_generators", "make_chain_farm_fused", "run_chains_fused",
           "run_chains_vmapped", "run_chains_sharded",
           "run_chains_data_sharded"]


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


def _seeded_from(seed: int, c: int, dev: torch.device) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(int(np.random.SeedSequence([seed, c]).generate_state(
        1)[0]))
    return g


def chain_generators(seed: int, chains: int, device=None
                     ) -> list[torch.Generator]:
    """One ``torch.Generator`` per chain on ``device``, chain c seeded from
    (seed, c) through NumPy's ``SeedSequence``: the port's counterpart of
    ``jax.random.split(key, chains)``."""
    dev = resolve_device(device)
    return [_seeded_from(seed, c, dev) for c in range(chains)]


def _chains_block(mesh, C: int) -> tuple:
    """(group, coordinate, slice of this rank's chains) on the mesh's
    chains axis."""
    group = mesh.get_group(AXIS_CHAINS)
    r, W = dist.get_rank(group), dist.get_world_size(group)
    if C % W:
        raise ValueError(f"{C} chains do not divide over the {W} ranks of "
                         f"the {AXIS_CHAINS!r} axis")
    b = C // W
    return group, r, slice(r * b, (r + 1) * b)


def _gather(tree, group):
    """Each leaf of a record tree gathered along its chain axis."""
    if isinstance(tree, dict):
        return {k: _gather(v, group) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_gather(v, group) for v in tree)
    return all_gather_cat(tree, group)


def run_chains_sharded(superstep: Callable, seed: int, theta0,
                       num_steps: int, mesh, collect: Optional[Callable] = None,
                       *, device=None):
    """C chains over the mesh's ``chains`` axis: each rank runs its block
    of C/W chains of theta0 (C, d) as one batch of the batched
    ``superstep`` (one ``batch_log_prob`` call a superstep over the
    block's states, as :func:`run_chains_vmapped`), drawing from a
    generator on ``device`` seeded from (seed, r), r the rank's chains
    coordinate.  Returns ``(final (C, d), records (C, steps, ...))``,
    gathered in chain order on every rank of the axis; a mesh of one rank
    equals ``run_chains_vmapped(superstep, chain_generators(seed, 1)[0],
    theta0, ...)`` bit for bit.  The superstep may hold collectives over
    the data and tree axes (a :class:`~pmpx_torch.parallel.ShardedLinReg`
    target, a tree-sharded superstep).  Raises ValueError when the axis's
    size does not divide C.
    """
    dev = resolve_device(device)
    theta = torch.as_tensor(theta0, device=dev)
    group, r, blk = _chains_block(mesh, theta.shape[0])
    final, recs = run_chains_vmapped(superstep, _seeded_from(seed, r, dev),
                                     theta[blk], num_steps, collect)
    return all_gather_cat(final, group), _gather(recs, group)


def run_chains_data_sharded(make_superstep_local: Callable, x, y, seed: int,
                            theta0, num_steps: int, mesh,
                            collect: Optional[Callable] = None, *,
                            device=None):
    """Chains over the ``chains`` axis x the likelihood's data over the
    ``data`` axis.

    Each rank takes the contiguous shard of the global (n,) ``x``, ``y``
    at its data coordinate, moves it to ``device`` and builds its
    superstep with ``make_superstep_local(x_shard, y_shard)`` (typically
    over a :class:`~pmpx_torch.parallel.ShardedLinReg` on the mesh, whose
    ``all_reduce`` over the data axis gives every rank of a data group the
    same weights); then :func:`run_chains_sharded`.  Raises ValueError
    when the data axis's size does not divide n, or the chains axis's C.
    """
    dev = resolve_device(device)
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    group = mesh.get_group(AXIS_DATA)
    r, D = dist.get_rank(group), dist.get_world_size(group)
    n = x.shape[0]
    if n % D:
        raise ValueError(f"{n} points do not divide over the {D} ranks of "
                         f"the {AXIS_DATA!r} axis")
    m = n // D
    superstep = make_superstep_local(x[r * m:(r + 1) * m].to(dev),
                                     y[r * m:(r + 1) * m].to(dev))
    return run_chains_sharded(superstep, seed, theta0, num_steps, mesh,
                              collect, device=dev)


def make_chain_farm_fused(target, cfg, num_steps: int, mesh=None, *,
                          chunk: int = 512, rng: str = "kernel") -> Callable:
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

    With a ``mesh``, every rank of its chains axis passes all C generators
    (and theta0, and ``uin``) and launches its contiguous block of C/W
    chains; the roots are gathered back in chain order on every rank of
    the axis (ValueError where W does not divide C).
    """
    if not fc.supports(cfg, "root"):
        raise ValueError(f"fused chain does not support {cfg}")
    if rng not in ("kernel", "input"):
        raise ValueError(f"unknown rng {rng!r}")
    consts = fc.chain_consts(target, cfg)
    dev = target.x2d.device

    def run(generators: Sequence[torch.Generator], theta0: torch.Tensor, *,
            uin: Optional[torch.Tensor] = None) -> torch.Tensor:
        theta = theta0.to(device=dev, dtype=torch.float32).contiguous()
        C = len(generators)
        if theta.shape != (C, 3):
            raise ValueError(f"{C} generators need theta0 ({C}, 3), got "
                             f"{tuple(theta.shape)}")
        if mesh is not None:
            group, _, blk = _chains_block(mesh, C)
            generators, theta = generators[blk], theta[blk]
            uin = None if uin is None else uin[:, blk]
        many = {"chains": len(generators)} if len(generators) > 1 else {}
        with span("farm.run", dev, steps=num_steps, **many):
            traces, _, _ = fc._run_chunks(
                target, generators, theta, num_steps, consts, chunk=chunk,
                rng=rng, uin=uin, spans="farm")
            with span("farm.gather", dev):
                roots = torch.cat(traces, dim=2)[:, :, :num_steps]
                roots = roots.transpose(1, 2)
                return roots if mesh is None else all_gather_cat(roots,
                                                                 group)

    return run


def run_chains_fused(target, cfg, generators: Sequence[torch.Generator],
                     theta0: torch.Tensor, num_steps: int, mesh=None, *,
                     chunk: int = 512, rng: str = "kernel") -> torch.Tensor:
    """One call of :func:`make_chain_farm_fused`'s runner: the
    (C, num_steps, 3) roots of C chains (over the mesh's chains axis where
    one is given)."""
    farm = make_chain_farm_fused(target, cfg, num_steps, mesh, chunk=chunk,
                                 rng=rng)
    return farm(generators, theta0)
