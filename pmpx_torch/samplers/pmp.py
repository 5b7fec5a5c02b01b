"""PMP — prefetching multiple-proposal MCMC, the unified tree engine (port
of ``pmpx/samplers/pmp.py``).

One engine covers the general (N, depth) tree, the binary prefetching tree
(``N=1``) and flat multiple-try Metropolis (``depth=1``).  A superstep:

1. proposal-tree generation: one (P, d) Gaussian innovation draw, positions
   as per-level tile patterns (:func:`tree_positions`);
2. batched target evaluation of all P nodes at once;
3. per-level generalized-MTM weights in log space (:func:`log_accept_tree`);
4. on-device categorical resampling and next-root selection.

A state of shape (C, d) is a batch of C chains: each superstep draws the
(C, P, d) innovations and every chain's uniforms in one call each from one
generator, evaluates all C*P states in one batched target call, and
resamples each chain from its own weights (``pmpx`` vmaps a chain per key
instead; the batch's chains have the same law, but chain c is not
reproducible on its own).  A state of shape (d,) is one chain.

On a card, a binary tree's steps 1, 3 and 4 run as two hand-written
kernels, one on each side of the target call
(:mod:`pmpx_torch.kernels.pmp_tree`); the functions here are their plain
versions, and the path of the CPU, of N > 1 and of trees too deep for one
block.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pmpx_torch import tree as tree_mod
from pmpx_torch.kernels import pmp_tree
from pmpx_torch.resample import categorical, categorical_many
from pmpx_torch.samplers.base import Target, batch_log_prob, declare_eager
from pmpx_torch.samplers.stabilize import stabilize_logits
from pmpx_torch.transition import GaussianRW

__all__ = [
    "PMPConfig",
    "tree_positions",
    "log_accept_tree",
    "select_and_emit",
    "make_superstep",
]


@dataclasses.dataclass(frozen=True)
class PMPConfig:
    """Configuration of one PMP sampler (the fields and checks of
    ``pmpx.samplers.pmp.PMPConfig``).

    N : proposals per node per level (branching factor).
    depth : speculation levels.  ``depth=1`` is flat MP; ``N=1`` is the
        binary prefetching tree.
    step_size : proposal random-walk sigma.
    trans_sigma : transition *density* sigma used in the MTM weights.
    trans_normalize_by : divide pairwise log-K by this.
    selection : ``"all_uniform"`` (emit all P draws, next root uniform
        among them), ``"all_first"`` (next root is draw 0) or ``"single"``
        (one draw is both the sample and the next root).
    stabilizer : ``"none"`` (exact) or ``"zscore"``.
    nan_guard : replace non-finite weights with weight 1.
    """

    N: int
    depth: int
    step_size: float
    trans_sigma: float = 1.0
    trans_normalize_by: float = 1.0
    selection: str = "all_uniform"
    stabilizer: str = "none"
    nan_guard: bool = True

    def __post_init__(self):
        if self.selection not in ("all_uniform", "all_first", "single"):
            raise ValueError(f"unknown selection mode {self.selection!r}")
        if self.N < 1:
            raise ValueError(f"N must be >= 1, got {self.N}")
        if self.depth < 1:
            raise ValueError(f"depth must be >= 1, got {self.depth}")
        if self.step_size <= 0:
            raise ValueError(f"step_size must be > 0, got {self.step_size}")
        if self.stabilizer not in ("none", "zscore"):
            raise ValueError(f"unknown stabilizer {self.stabilizer!r}")

    @property
    def P(self) -> int:
        return tree_mod.num_nodes(self.N, self.depth)

    def topology(self) -> tree_mod.TreeTopology:
        return tree_mod.topology(self.N, self.depth)

    def transition(self) -> GaussianRW:
        return GaussianRW(
            sigma=self.trans_sigma, normalize_by=self.trans_normalize_by
        )


def tree_positions(
    theta: torch.Tensor, eps: torch.Tensor, topo: tree_mod.TreeTopology
) -> torch.Tensor:
    """All P speculative positions from the current state and innovations.

    ``theta`` (..., d), ``eps`` (..., P, d) -> (..., P, d), leading axes
    a batch of chains.  ``Y[x] = theta + sum of eps over the root->x
    creation path``: node x picks up ``eps[x mod (N+1)**(i+1)]`` at level
    i iff digit i of x is nonzero.  Within the first ``m = (N+1)**(i+1)``
    indices that is eps with its first ``(N+1)**i`` rows zeroed, tiled
    over the node axis; the levels are added in order, as ``pmpx`` adds
    them.  ``eps[..., 0, :]`` is ignored (the root carries no innovation).
    """
    *batch, P, d = eps.shape
    base = topo.N + 1
    Y = theta[..., None, :].to(eps.dtype).expand(eps.shape)
    for i in range(topo.depth):
        temp = base**i
        m = temp * base
        blk = torch.cat(
            [eps.new_zeros((*batch, temp, d)), eps[..., temp:m, :]], dim=-2
        )
        Y = Y + blk.repeat(*[1] * len(batch), P // m, 1)
    return Y


def log_accept_tree(
    Y: torch.Tensor,
    logpi: torch.Tensor,
    topo: tree_mod.TreeTopology,
    trans: GaussianRW,
) -> torch.Tensor:
    """Per-node log acceptance weights via the per-level generalized-MTM walk.

    ``Y`` (..., P, d), ``logpi`` (..., P) -> (..., P), leading axes a
    batch of chains.  For each level i with stride ``temp=(N+1)**i`` and
    sibling groups ``m[h, j] = h + j*temp``:

        w[h, j] = pi(Y[m_hj]) * prod_{k != j} K(Y[m_hj] -> Y[m_hk])
        contribution[x] = log( w[h_i(x), c_i(x)] / sum_j w[h_i(x), j] )

    summed over levels; deeper nodes inherit their ancestor's factor as a
    tile.  For N=1 the symmetric K factor cancels in every Barker pair and
    is dropped, as in ``pmpx``.
    """
    batch = logpi.shape[:-1]
    base = topo.N + 1
    P = topo.P
    logA = Y.new_zeros(logpi.shape)
    for i in range(topo.depth):
        temp = base**i
        m = temp * base
        lp_blk = logpi[..., :m].reshape(*batch, base, temp).transpose(-1, -2)
        if topo.N == 1:
            lw = lp_blk
        else:
            # (..., temp, base, d): group h's members h + j*temp
            G = Y[..., :m, :].reshape(*batch, base, temp, Y.shape[-1])
            # (..., temp, base, base)
            logK = trans.pairwise(G.transpose(-3, -2))
            offdiag = torch.sum(logK, dim=-1) - torch.diagonal(
                logK, dim1=-2, dim2=-1
            )
            lw = lp_blk + offdiag
        contrib = lw - torch.logsumexp(lw, dim=-1, keepdim=True)
        block = contrib.transpose(-1, -2).reshape(*batch, m)
        logA = logA + block.repeat(*[1] * len(batch), P // m)
    return logA


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[..., idx, ...]`` along the node axis ``idx.dim()`` of ``a``,
    one index per chain of the batch ``idx`` (..,): a gather, so no host
    sync (plain indexing with a tensor scalar reads it back to the
    host)."""
    k = idx.dim()
    index = idx.long().reshape(idx.shape + (1,) * (a.dim() - k))
    return torch.take_along_dim(a, index, dim=k).squeeze(k)


def select_and_emit(
    cfg: PMPConfig,
    Y: torch.Tensor,
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    u: Optional[torch.Tensor] = None,
    pick: Optional[torch.Tensor] = None,
):
    """Resampling + next-root selection shared by all tree samplers.

    ``Y`` (..., P, d) and ``logits`` (..., P), leading axes a batch of
    chains.  ``u`` replaces the resampling uniforms ((..., 1) for
    ``single``, (..., P) otherwise) and ``pick`` (...) the uniform root
    slot of ``all_uniform``.  Returns ``(theta', samples, root_index)``.
    """
    P = Y.shape[-2]
    batch = logits.shape[:-1]
    if cfg.selection == "single":
        idx = categorical(logits, generator=generator, u=u)
        theta2 = _take(Y, idx)
        return theta2, theta2[..., None, :], idx
    draws = categorical_many(logits, P, generator=generator, u=u)
    samples = torch.take_along_dim(Y, draws.long()[..., None], dim=-2)
    if cfg.selection == "all_uniform":
        if pick is None:
            pick = torch.randint(
                0, P, batch, generator=generator, device=Y.device
            )
        root = _take(draws, pick)
    else:  # all_first
        root = draws[..., 0]
    return _take(Y, root), samples, root


def make_superstep(target: Target, cfg: PMPConfig):
    """Build ``superstep(generator, theta, *, eps=None, u=None, pick=None)
    -> (theta', out)``.

    ``theta`` is one chain's state (d,) or a batch of chains' (C, d); the
    batch's C*P positions go to the target in one ``batch_log_prob``
    call.  ``eps`` ((..., P, d) innovations, already scaled by the step
    size), ``u`` and ``pick`` replace the draws from ``generator``, with
    the state's leading axes, so a test can replay the noise of a
    ``pmpx`` superstep.  ``out`` holds ``samples``, ``log_accept``,
    ``root_index`` and ``root_logp`` (the chosen state's log-density),
    each with the state's leading axes.

    A binary tree over float32 states on a card runs its tree in the two
    kernels of :mod:`pmpx_torch.kernels.pmp_tree` (where
    ``pmp_tree.engages``), one on each side of the target call, with the
    same generator calls in the same order as the torch path: ``randn``
    before the target, ``rand`` after it, ``randint`` last.
    """
    topo = cfg.topology()
    trans = cfg.transition()
    P, d = topo.P, target.d

    def on_card(generator, theta, eps, u, pick):
        batch = theta.shape[:-1]
        C = theta[..., 0].numel()
        scale, drawn = 1.0, eps is None
        if drawn:
            eps = torch.randn((*batch, P, d), generator=generator,
                              device=theta.device, dtype=theta.dtype)
            scale = cfg.step_size
        # innovations drawn here are scratch: the positions may overwrite
        # them, so that the superstep never holds both (P, d) buffers
        Y = pmp_tree.tree_positions(theta.reshape(C, d).contiguous(),
                                    eps.reshape(C, P, d).contiguous(),
                                    cfg.depth, scale, overwrite=drawn)
        del eps
        logpi = batch_log_prob(target, Y.reshape(-1, d), generator)
        num = 1 if cfg.selection == "single" else P
        if u is None:
            u = torch.rand((*batch, num), generator=generator,
                           device=Y.device, dtype=logpi.dtype)
        if cfg.selection == "all_uniform" and pick is None:
            pick = torch.randint(0, P, batch, generator=generator,
                                 device=Y.device)
        theta2, samples, root, logA, root_logp = pmp_tree.tree_select(
            cfg, Y, logpi.reshape(C, P), u.reshape(C, num).contiguous(),
            None if pick is None else pick.reshape(C).long())
        return theta2.reshape(theta.shape), {
            "samples": samples.reshape(*batch, -1, d),
            "log_accept": logA.reshape(*batch, P),
            "root_index": root.reshape(batch),
            "root_logp": root_logp.reshape(batch),
        }

    def superstep(generator, theta, *, eps=None, u=None, pick=None):
        if pmp_tree.engages(cfg, theta):
            return on_card(generator, theta, eps, u, pick)
        batch = theta.shape[:-1]
        if eps is None:
            eps = cfg.step_size * torch.randn(
                (*batch, P, d), generator=generator, device=theta.device,
                dtype=theta.dtype,
            )
        Y = tree_positions(theta, eps, topo)
        logpi = batch_log_prob(
            target, Y.reshape(-1, d), generator
        ).reshape(*batch, P)
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

    return declare_eager(superstep, getattr(target, "eager_only", None))
