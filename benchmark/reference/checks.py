"""The numbers that decide ``correct``, each a plain function of outputs
and of the reference's values.

* :func:`moment_z`: how far the draws' means and variances lie from the
  exact posterior's, in Monte Carlo standard errors.  For coordinate j
  and chains c of n_c draws (N in all), the mean's standard error is
  sqrt(sum_c (n_c / N)^2 s_c^2 / ESS_c), s_c^2 chain c's variance and
  ESS_c its Geyer ESS; the variance is judged as the mean of (x_j -
  mu_j)^2 against the exact variance, with the same error formula on
  that series.  The number is the largest |z| over the 3 means and 3
  variances.  Draws of a sound chain give |z| of a standard normal's
  size whatever their count; a chain that is stuck, that samples another
  law, or whose draws are altered gives |z| that grows with the draws.
  A stuck chain has no variance and reads infinity.
* :func:`logp_gap`: the largest relative gap between the log-density that
  the program reported for a state and the reference's, over a sample of
  states.
* :func:`stay_share`: the share of supersteps after which the state did
  not move.
* :func:`select_z`: how far the slots a chain chose lie from its selection
  law, in standard errors.  Superstep t's law is softmax of its P
  weights after the configuration's stabiliser (``zscore``: minus their
  mean, over their population standard deviation); with p_t that law and
  k_t the chosen slot, sum_t log p_t[k_t] is compared with its
  expectation sum_t sum_i p_ti log p_ti, over the square root of the sum
  of each term's variance.  Each slot is drawn afresh given the past, so
  a sound chain reads |z| of a standard normal's size whatever the
  number of supersteps; a walk that ignores the weights, or that always
  takes the best, reads |z| that grows with them.  A slot of weight 0
  reads infinity.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.ess import ess_columns

__all__ = ["moment_z", "logp_gap", "stay_share", "select_z", "chain_ess"]


def chain_ess(draws: torch.Tensor) -> torch.Tensor:
    """ESS (C, k) of each chain's columns, draws (C, T, k)."""
    C, T, k = draws.shape
    cols = draws.permute(1, 0, 2).reshape(T, C * k)
    return ess_columns(cols).reshape(C, k)


def _z(series: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """|z| of each column's pooled mean against ``target`` (k,), series
    (C, T, k) float64."""
    C, T, _ = series.shape
    ess = chain_ess(series)
    var = series.var(dim=1)
    se2 = ((var / ess) / (C * C)).sum(0)
    mean = series.mean(dim=(0, 1))
    z = (mean - target).abs() / torch.sqrt(se2)
    return torch.where(torch.isfinite(z), z,
                       torch.full_like(z, float("inf")))


def moment_z(draws: torch.Tensor, mean: torch.Tensor,
             var: torch.Tensor) -> dict:
    """``draws`` (C, T, 3) or (T, 3); ``mean`` and ``var`` the exact
    posterior's (3,).  Returns ``{"value": max |z|, "mean_z": [...],
    "var_z": [...]}``."""
    d = draws.double()
    if d.dim() == 2:
        d = d[None]
    mu = mean.to(d.device).double()
    z_mean = _z(d, mu)
    z_var = _z((d - mu) ** 2, var.to(d.device).double())
    both = torch.cat([z_mean, z_var])
    value = float(both.max()) if not torch.isnan(both).any() else math.inf
    return {"value": value, "mean_z": z_mean.tolist(),
            "var_z": z_var.tolist()}


def logp_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """max |program - reference| / |reference| over the states compared
    (infinite where the program's value is not finite)."""
    p, r = program.double().to(reference.device), reference.double()
    gap = (p - r).abs() / r.abs().clamp(min=1e-30)
    gap = torch.where(torch.isfinite(gap), gap,
                      torch.full_like(gap, float("inf")))
    return float(gap.max())


def stay_share(states: torch.Tensor, first: torch.Tensor) -> float:
    """Share of supersteps whose state equals the one before it; states
    (T, d), ``first`` (d,) the state before the first of them."""
    prev = torch.cat([first[None].to(states.device), states[:-1]])
    same = (states == prev).all(dim=1)
    return float(same.double().mean())


def stabilized(log_accept: torch.Tensor, stabilizer: str) -> torch.Tensor:
    """The selection's logits from the weights (..., P) in float64:
    ``none`` as they are, ``zscore`` standardised over the last axis; NaN
    and +inf become 0."""
    s = log_accept.double()
    if stabilizer == "zscore":
        std = s.std(dim=-1, correction=0, keepdim=True)
        s = (s - s.mean(dim=-1, keepdim=True)) / std.clamp(min=1e-30)
    elif stabilizer != "none":
        raise ValueError(f"unknown stabilizer {stabilizer!r}")
    bad = torch.isnan(s) | (s == math.inf)
    return torch.where(bad, torch.zeros_like(s), s)


def select_z(log_accept: torch.Tensor, chosen: torch.Tensor,
             stabilizer: str) -> float:
    """|z| of the chosen slots (T,) against the selection law of the
    weights (T, P) a superstep computed."""
    logp = torch.log_softmax(stabilized(log_accept, stabilizer), dim=-1)
    p = logp.exp()
    plogp = torch.where(p > 0, p * logp, torch.zeros_like(p))
    mean = plogp.sum(-1)
    second = torch.where(p > 0, plogp * logp, torch.zeros_like(p)).sum(-1)
    got = logp.gather(-1, chosen.to(logp.device).long()[:, None])[:, 0]
    z = (got.sum() - mean.sum()) / (second - mean * mean).sum().sqrt()
    z = float(z.abs())
    return z if math.isfinite(z) else math.inf
