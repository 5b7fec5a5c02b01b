"""Single-proposal Metropolis-Hastings, the reference's SP/MH baselines
(port of ``pmpx/samplers/mh.py``).

Two acceptance rules:

* ``"barker"`` — accept with probability pi(y)/(pi(x)+pi(y));
* ``"metropolis"`` — accept with probability min(1, pi(y)/pi(x)).

The proposal is an isotropic Gaussian random walk of scale ``step_size``,
or ``uniform(-step_size, step_size)`` per coordinate (the reference SP's
parity case).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pmpx_torch.samplers.base import Target, batch_log_prob, declare_eager

__all__ = ["MHConfig", "make_superstep"]


@dataclasses.dataclass(frozen=True)
class MHConfig:
    step_size: float
    rule: str = "metropolis"  # or "barker"
    proposal: str = "normal"  # or "uniform"

    def __post_init__(self):
        if self.rule not in ("metropolis", "barker"):
            raise ValueError(f"unknown MH rule {self.rule!r}")
        if self.proposal not in ("normal", "uniform"):
            raise ValueError(f"unknown proposal {self.proposal!r}")


def make_superstep(target: Target, cfg: MHConfig):
    """Build ``superstep(generator, theta, *, eps=None, u=None) ->
    (theta', out)``.

    ``theta`` is one chain's state (d,) or a batch of chains' (C, d); the
    current and proposed states of the whole batch go to the target in
    one ``batch_log_prob`` call.  ``eps`` (the proposal's increment, the
    state's shape) and ``u`` (the acceptance uniforms, the state's leading
    axes) replace the draws from ``generator``, so a test can replay the
    noise of a ``pmpx`` superstep.  ``out`` holds ``samples`` (..., 1,
    d), ``accepted``, ``log_accept`` and ``root_logp`` (the chosen
    state's log-density).
    """

    def superstep(generator: Optional[torch.Generator], theta, *, eps=None,
                  u=None):
        if eps is None:
            if cfg.proposal == "normal":
                eps = cfg.step_size * torch.randn(
                    theta.shape, generator=generator, device=theta.device,
                    dtype=theta.dtype,
                )
            else:
                eps = cfg.step_size * (2.0 * torch.rand(
                    theta.shape, generator=generator, device=theta.device,
                    dtype=theta.dtype,
                ) - 1.0)
        prop = theta + eps
        # one batched call for {current, proposal} of every chain
        pair = torch.stack([theta, prop], dim=-2)
        lp = batch_log_prob(
            target, pair.reshape(-1, theta.shape[-1]), generator
        ).reshape(pair.shape[:-1])
        lp_cur, lp_prop = lp[..., 0], lp[..., 1]
        if cfg.rule == "metropolis":
            log_acc = torch.clamp(lp_prop - lp_cur, max=0.0)
        else:  # barker: p'/(p+p')
            log_acc = lp_prop - torch.logaddexp(lp_cur, lp_prop)
        if u is None:
            u = torch.rand(theta.shape[:-1], generator=generator,
                           device=theta.device, dtype=theta.dtype)
        accept = torch.log(u) < log_acc
        theta2 = torch.where(accept[..., None], prop, theta)
        return theta2, {
            "samples": theta2[..., None, :],
            "accepted": accept,
            "log_accept": log_acc,
            "root_logp": torch.where(accept, lp_prop, lp_cur),
        }

    return declare_eager(superstep, getattr(target, "eager_only", None))
