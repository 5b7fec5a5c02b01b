"""HMC-flavoured samplers: SP-HMC, MP-HMC and the PMP-HMC speculation tree
(port of ``pmpx/samplers/hmc.py``).

The reference's gradient-proposal family (``complex_nets/Cifar-10/
cifar_{SP,MP,PMP}hmc.py``, ``Bayesian Network Training/main.py``):

* **SP-HMC**: ``num_leapfrog`` leapfrog steps a superstep, momentum ``p ~
  mom_scale * N(0, I)``, acceptance ``exp(min(0, (H1 - H0) *
  accept_scale))``.
* **MP-HMC**: one trajectory of N leapfrog steps with a uniformly random
  reversal point ``ranint`` in 1..N after which the step's sign flips;
  weights ``A_j = exp(min(0, H_j - H_0))`` for j >= 1 and ``A_0 = N - sum_j
  A_j``; one categorical draw.
* **PMP-HMC**: the general (N, depth) mixed-radix tree, every edge one
  leapfrog step with a fresh momentum from the parent's cached gradient;
  the tree walk takes the rules ``barker``, ``mh_clamp`` and
  ``barker_clamp`` (which ``pmpx`` shows equal to ``mh_clamp``
  numerically).  Generation and walk are gather-free: level i's children
  fill the node slice ``[(N+1)**i, (N+1)**(i+1))``.

Gradients come from the target's ``value_and_grad_batch`` when it has one
(``BayesLinReg``'s is closed-form, its values from ``linreg_rss`` on the
sweep; ``NNPosterior``'s a ``torch.func`` vmap), else from
``torch.func.vmap(torch.func.grad_and_value(log_prob))``.  A stochastic
target (``needs_rng``) gets the chain's generator at every density
evaluation, so each evaluation draws its own noise.

Like the other supersteps, each takes optional injected noise so that a
test can replay a ``pmpx`` superstep: ``mom`` (the momenta, already scaled
by ``mom_scale``; for PMP-HMC a (P, d) tensor whose rows ``[(N+1)**i,
(N+1)**(i+1))`` are level i's edges in node order, row 0 unused), ``u``
(the acceptance or resampling uniforms), MP's ``ranint`` and PMP's
``pick``.  Nothing reads a value back to the host inside a superstep.  A
state is one chain's (d,).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch.func import grad_and_value, vmap

from pmpx_torch.resample import categorical
from pmpx_torch.samplers.base import Target, declare_eager
from pmpx_torch.samplers.pmp import _take, select_and_emit
from pmpx_torch.samplers.stabilize import stabilize_logits

__all__ = ["HMCConfig", "MPHMCConfig", "PMPHMCConfig", "make_superstep"]


def _value_and_grad_batch(target: Target) -> Callable:
    """``vg(Theta (B, d), generator) -> (values (B,), grads (B, d))``; the
    generator reaches only stochastic targets."""
    fused = getattr(target, "value_and_grad_batch", None)
    needs = getattr(target, "needs_rng", False)
    if fused is not None:
        if needs:
            return lambda Theta, gen: fused(Theta, generator=gen)
        return lambda Theta, gen: fused(Theta)
    if needs:
        # no vmap: a random op under vmap cannot take the explicit
        # generator, so each row draws its own noise in turn
        def vg_rows(Theta, gen):
            g = grad_and_value(lambda t: target.log_prob(t, generator=gen))
            grads, vals = zip(*(g(t) for t in Theta))
            return torch.stack(vals), torch.stack(grads)

        return vg_rows
    g = vmap(grad_and_value(target.log_prob))

    def vg(Theta, gen):
        grads, vals = g(Theta)
        return vals, grads

    return vg


def _leapfrog(vg, theta, p, step_size, generator):
    """One leapfrog step for a batch of (B, d) positions and momenta.

    Returns (theta', p', logpi(theta'), grad(theta')).  The gradient at
    theta is evaluated afresh (one vg call), then one vg call at theta',
    as ``pmpx`` does; a stochastic target draws new noise at each."""
    _, g0 = vg(theta, generator)
    p_half = p + 0.5 * step_size * g0
    theta2 = theta + step_size * p_half
    lp2, g2 = vg(theta2, generator)
    p2 = p_half + 0.5 * step_size * g2
    return theta2, p2, lp2, g2


def _normal(generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=like.device,
                       dtype=like.dtype)


# --------------------------------------------------------------------------
# SP-HMC
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HMCConfig:
    step_size: float
    mom_scale: float = 1.0
    accept_scale: float = 1.0
    num_leapfrog: int = 1


def _make_sp_hmc(target: Target, cfg: HMCConfig):
    vg = _value_and_grad_batch(target)

    def superstep(generator, theta, *, mom=None, u=None):
        p0 = (cfg.mom_scale * _normal(generator, theta.shape, theta)
              if mom is None else mom)
        lp0, _ = vg(theta[None, :], generator)
        th, p = theta[None, :], p0[None, :]
        for _ in range(cfg.num_leapfrog):
            th, p, lp1, _ = _leapfrog(vg, th, p, cfg.step_size, generator)
        h0 = lp0[0] - 0.5 * torch.sum(p0 * p0)
        h1 = lp1[0] - 0.5 * torch.sum(p[0] * p[0])
        log_acc = torch.clamp((h1 - h0) * cfg.accept_scale, max=0.0)
        if u is None:
            u = torch.rand((), generator=generator, device=theta.device,
                           dtype=theta.dtype)
        accept = torch.log(u) < log_acc
        theta2 = torch.where(accept, th[0], theta)
        return theta2, {
            "samples": theta2[None, :],
            "accepted": accept,
            "log_accept": log_acc,
        }

    return superstep


# --------------------------------------------------------------------------
# MP-HMC: one trajectory, a random reversal point
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MPHMCConfig:
    N: int
    step_size: float
    mom_scale: float = 1.0
    nan_guard: bool = True


def _make_mp_hmc(target: Target, cfg: MPHMCConfig):
    vg = _value_and_grad_batch(target)
    N = cfg.N

    def superstep(generator, theta, *, mom=None, ranint=None, u=None):
        p0 = (cfg.mom_scale * _normal(generator, theta.shape, theta)
              if mom is None else mom)
        # steps with index >= ranint flip sign (cifar_MPhmc.py:103-108)
        if ranint is None:
            ranint = torch.randint(1, N + 1, (), generator=generator,
                                   device=theta.device)
        lp0, _ = vg(theta[None, :], generator)
        th, p = theta[None, :], p0[None, :]
        traj, lps, kes = [theta], [], []
        for i in range(N):
            sign = torch.where(ranint <= i, -1.0, 1.0).to(theta.dtype)
            th, p, lp, _ = _leapfrog(vg, th, p, sign * cfg.step_size,
                                     generator)
            traj.append(th[0])
            lps.append(lp[0])
            kes.append(0.5 * torch.sum(p[0] * p[0]))
        # states 0..N: index 0 is the current one
        Y = torch.stack(traj)
        h = torch.cat([(lp0[0] - 0.5 * torch.sum(p0 * p0))[None],
                       torch.stack(lps) - torch.stack(kes)])
        # A_j = exp(min(0, H_j - H_0)), A_0 = N - sum_j A_j
        # (cifar_MPhmc.py:79-84)
        A_tail = torch.exp(torch.clamp(h[1:] - h[0], max=0.0))
        A = torch.cat([(N - torch.sum(A_tail))[None], A_tail])
        if cfg.nan_guard:
            A = torch.where(torch.isfinite(A), A, torch.ones_like(A))
        A = torch.clamp(A, min=0.0)
        logA = torch.log(A + 1e-30)
        idx = categorical(logA, generator=generator, u=u)
        theta2 = _take(Y, idx)
        return theta2, {
            "samples": theta2[None, :],
            "log_accept": logA,
            "root_index": idx,
        }

    return superstep


# --------------------------------------------------------------------------
# PMP-HMC: the speculation tree of leapfrog edges
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PMPHMCConfig:
    """PMP-HMC speculation tree (the fields and checks of ``pmpx``'s).

    ``N`` leapfrog children a node, ``depth`` levels.  The reference builds
    binary trees only (``N=1``, ``cifar_PMPhmc.py:114-171``); at every
    level each sibling group of N fresh-momentum candidates is one
    mixture-of-kernels decision (a candidate picked uniformly, accepted by
    its own per-edge Hamiltonian rule), the reference's pairwise rules at
    ``N=1``.
    """

    depth: int
    step_size: float
    N: int = 1
    mom_scale: float = 1.0
    rule: str = "barker"  # | "mh_clamp" | "barker_clamp"
    stabilizer: str = "none"
    nan_guard: bool = True
    selection: str = "single"  # | "all_uniform" | "all_first"

    def __post_init__(self):
        if self.rule not in ("barker", "mh_clamp", "barker_clamp"):
            raise ValueError(f"unknown PMP-HMC rule {self.rule!r}")
        if self.selection not in ("single", "all_uniform", "all_first"):
            raise ValueError(f"unknown selection {self.selection!r}")
        if self.N < 1:
            raise ValueError(f"N must be >= 1, got {self.N}")
        if self.depth < 1:
            raise ValueError(f"depth must be >= 1, got {self.depth}")

    @property
    def P(self) -> int:
        return (self.N + 1) ** self.depth


def _make_pmp_hmc(target: Target, cfg: PMPHMCConfig):
    """Node x at level i belongs to sibling group ``x mod (N+1)**i`` as
    member ``c_i(x)``.  Level i's N*temp edges take their leapfrog step in
    one vg call, from the parents tiled N times, and land in the node slice
    ``[temp, (N+1)*temp)`` in (member, group) order.  Per level, with
    ``dh_j = H(y_j, p_j') - H(parent, p_j)`` and ``a_j`` its rule's
    acceptance: P(member j) = a_j / N, P(member 0) = 1 - sum_j a_j / N
    (clamped at 1e-30 in log space)."""
    vg = _value_and_grad_batch(target)
    D, N = cfg.depth, cfg.N
    base = N + 1
    P = base**D
    d = target.d

    def superstep(generator, theta, *, mom=None, u=None, pick=None):
        if mom is None:
            mom = cfg.mom_scale * _normal(generator, (P, d), theta)
        lp_root, g_root = vg(theta[None, :], generator)
        Y, logpi, G = theta[None, :], lp_root, g_root
        ke_init, ke_fin = [theta.new_zeros(1)], [theta.new_zeros(1)]
        for i in range(D):
            temp = base**i
            parents = Y[:temp].repeat(N, 1)
            g_par = G[:temp].repeat(N, 1)
            p0 = mom[temp:base * temp]
            # leapfrog from the cached parent gradient
            p_half = p0 + 0.5 * cfg.step_size * g_par
            child = parents + cfg.step_size * p_half
            lp_c, g_c = vg(child, generator)
            p_fin = p_half + 0.5 * cfg.step_size * g_c
            Y = torch.cat([Y, child])
            logpi = torch.cat([logpi, lp_c])
            G = torch.cat([G, g_c])
            ke_init.append(0.5 * torch.sum(p0 * p0, dim=-1))
            ke_fin.append(0.5 * torch.sum(p_fin * p_fin, dim=-1))
        ke_init, ke_fin = torch.cat(ke_init), torch.cat(ke_fin)

        # the tree walk, gather-free
        logA = theta.new_zeros(P)
        for c in range(D):
            temp = base**c
            blk = slice(temp, base * temp)
            lp_ch = logpi[blk].reshape(N, temp)
            kei = ke_init[blk].reshape(N, temp)
            kef = ke_fin[blk].reshape(N, temp)
            dh = (lp_ch - kef) - (logpi[:temp][None, :] - kei)  # (N, temp)
            if cfg.rule == "barker":
                la = F.logsigmoid(dh)
                if N == 1:
                    lparent = F.logsigmoid(-dh)[0]
                else:
                    lparent = torch.log(torch.clamp(
                        1.0 - torch.sum(torch.exp(la), dim=0) / N, min=1e-30))
            else:
                # mh_clamp (cifar_PMPhmc.py:94-102); barker_clamp
                # (main.py:84-99) Barker-normalises the same masses by a
                # normaliser that is identically 1
                la = torch.clamp(dh, max=0.0)
                lparent = torch.log(torch.clamp(
                    1.0 - torch.sum(torch.exp(la), dim=0) / N, min=1e-30))
            # f[m, h] for member m of group h at this level; node x =
            # q*(base*temp) + m*temp + h picks it through a reshape
            f = torch.cat([lparent[None, :], la - math.log(N)], dim=0)
            logA = (logA.reshape(-1, base, temp) + f[None]).reshape(P)

        logits = stabilize_logits(logA, cfg.stabilizer, cfg.nan_guard)
        theta2, samples, root = select_and_emit(
            cfg, Y, logits, generator, u=u, pick=pick
        )
        return theta2, {
            "samples": samples,
            "log_accept": logA,
            "root_index": root,
        }

    return superstep


def make_superstep(target: Target, cfg):
    """``superstep(generator, theta, **injected) -> (theta', out)`` for an
    :class:`HMCConfig`, :class:`MPHMCConfig` or :class:`PMPHMCConfig`."""
    if isinstance(cfg, HMCConfig):
        superstep = _make_sp_hmc(target, cfg)
    elif isinstance(cfg, MPHMCConfig):
        superstep = _make_mp_hmc(target, cfg)
    elif isinstance(cfg, PMPHMCConfig):
        superstep = _make_pmp_hmc(target, cfg)
    else:
        raise TypeError(f"unknown HMC config type {type(cfg)!r}")
    return declare_eager(superstep, getattr(target, "eager_only", None))
