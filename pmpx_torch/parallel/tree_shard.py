"""The tree axis: the P speculative states split over ranks (port of
``pmpx/parallel/tree_shard.py``).

The expensive stage of a superstep is the batched target evaluation of
all P states.  Here each rank of the tree axis evaluates a contiguous
block of P/T nodes, and one all-gather of the (P,) log-densities restores
the full weight vector.  The proposals, the tree walk, the stabiliser and
the resampling are replicated: every rank of a tree group holds the same
state and draws the same noise, so their resampling decisions agree with
no second collective.

Composes with the data axis: a :class:`pmpx_torch.parallel.ShardedLinReg`
target's ``all_reduce`` runs inside the block's evaluation.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pmpx_torch.parallel.mesh import AXIS_TREE, all_gather_cat
from pmpx_torch.samplers.base import Target, batch_log_prob, declare_eager
from pmpx_torch.samplers.pmp import (
    PMPConfig,
    _take,
    log_accept_tree,
    select_and_emit,
    tree_positions,
)
from pmpx_torch.samplers.stabilize import stabilize_logits

__all__ = ["make_tree_sharded_superstep"]


def make_tree_sharded_superstep(target: Target, cfg: PMPConfig,
                                axis: str = AXIS_TREE, *, mesh):
    """The PMP superstep of :func:`pmpx_torch.samplers.pmp.make_superstep`
    with the target's evaluation split over the tree axis: ``superstep(
    generator, theta, *, eps=None, u=None, pick=None) -> (theta', out)``.

    The evaluation splits over ``mesh``'s group of ``axis``.  Every rank
    of the group passes the same state and a
    generator in the same state (or the same injected noise), and draws
    its noise in the plain superstep's order, so that a group of one rank
    gives the plain superstep's result bit for bit.  A stochastic target
    draws only its block's noise.  Raises ValueError when the axis's size
    does not divide P.
    """
    topo = cfg.topology()
    trans = cfg.transition()
    P, d = topo.P, target.d
    grp = mesh.get_group(axis)
    ti, T = dist.get_rank(grp), dist.get_world_size(grp)
    if P % T:
        raise ValueError(f"the {T} ranks of the {axis!r} axis do not "
                         f"divide P = {P}")
    blk = P // T

    def superstep(generator, theta, *, eps=None, u=None, pick=None):
        batch = theta.shape[:-1]
        if eps is None:
            eps = cfg.step_size * torch.randn(
                (*batch, P, d), generator=generator, device=theta.device,
                dtype=theta.dtype,
            )
        Y = tree_positions(theta, eps, topo)
        Y_local = Y[..., ti * blk:(ti + 1) * blk, :]
        lp_local = batch_log_prob(
            target, Y_local.reshape(-1, d), generator
        ).reshape(*batch, blk)
        logpi = all_gather_cat(lp_local, grp, dim=-1)
        logA = log_accept_tree(Y, logpi, topo, trans)
        logits = stabilize_logits(logA, cfg.stabilizer, cfg.nan_guard)
        theta2, samples, root = select_and_emit(
            cfg, Y, logits, generator, u=u, pick=pick
        )
        return theta2, {
            "samples": samples,
            "log_accept": logA,
            "root_index": root,
            "root_logp": _take(logpi, root),
        }

    # the gather is a collective (on gloo a copy through the host), which
    # no CUDA graph of one rank holds: run_chain keeps it eager
    return declare_eager(
        superstep, "its evaluation all-gathers over the tree axis")
