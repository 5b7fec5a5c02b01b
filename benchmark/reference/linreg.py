"""Plain reference of the Bayesian linear regression configurations.

Independent of the program: it imports nothing of ``pmpx_torch`` and takes
nothing the program made.  It holds

* the inputs' law (:func:`make_data`): x ~ U(-1, 1), y = -1 + 2x +
  0.5 N(0, 1), n points drawn on the device from the run's seed, handed to
  the program and to the checks alike;
* the exact tempered posterior (:func:`exact_posterior`): theta = (b0, b1,
  sigma), log pi = temper * (-n log|sigma| - RSS(b) / (2 sigma^2)) + const
  under a flat prior, sigma > 0 (the chains start at sigma = 1 and the
  density vanishes at 0).  Given sigma, b ~ N(b_hat, sigma^2 / temper *
  (X'X)^-1); sigma's marginal is proportional to sigma^(2 - n temper)
  exp(-temper R / (2 sigma^2)), R = RSS(b_hat), whose moments are ratios
  of gamma functions.  All in float64;
* the log-density of given states over every point (:func:`log_density`),
  in float64;
* a plain PMP sampler (:func:`pmp_chains`): binary prefetching tree of the
  given depth, the Barker walk, one categorical draw a superstep (the law
  of ``selection="all_first"``), in any dtype, over C chains at once.  It
  is the control's sampler: run in bfloat16 it must fail the check.
"""

from __future__ import annotations

import math

import torch

__all__ = ["make_data", "exact_posterior", "log_density", "pmp_chains",
           "posterior_draws"]

_LOG_2PI = math.log(2.0 * math.pi)


def make_data(seed: int, n: int, device) -> tuple:
    """(x, y) float32 on ``device`` from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    x = 2.0 * torch.rand((n,), generator=gen, device=device) - 1.0
    y = -1.0 + 2.0 * x + 0.5 * torch.randn((n,), generator=gen,
                                           device=device)
    return x, y


def exact_posterior(x: torch.Tensor, y: torch.Tensor, temper: float) -> dict:
    """Mean and variance of (b0, b1, sigma) under the tempered posterior of
    the float32 data ``x``, ``y`` (float64 CPU tensors of 3)."""
    x, y = x.double(), y.double()
    n = x.shape[0]
    X = torch.stack([torch.ones_like(x), x], dim=1)
    A = X.T @ X
    b_hat = torch.linalg.solve(A, X.T @ y)
    resid = y - X @ b_hat
    R = float(resid @ resid)
    k = n * temper - 2.0
    c = temper * R / 2.0
    lg = math.lgamma
    e_s = math.sqrt(c) * math.exp(lg((k - 2) / 2) - lg((k - 1) / 2))
    e_s2 = c / ((k - 3) / 2)
    var_b = e_s2 / temper * torch.linalg.inv(A).diagonal()
    mean = torch.tensor([float(b_hat[0]), float(b_hat[1]), e_s],
                        dtype=torch.float64)
    var = torch.tensor([float(var_b[0]), float(var_b[1]), e_s2 - e_s * e_s],
                       dtype=torch.float64)
    return {"mean": mean, "var": var, "b_hat": b_hat.cpu(), "R": R,
            "A": A.cpu(), "k": k, "c": c}


def posterior_draws(post: dict, temper: float, C: int,
                    gen: torch.Generator) -> torch.Tensor:
    """C exact draws (C, 3) float64 on ``gen``'s device: sigma^2 = c / G,
    G ~ Gamma((k - 1) / 2), then b given sigma."""
    dev = gen.device
    shape = torch.full((C,), (post["k"] - 1) / 2, dtype=torch.float64,
                       device=dev)
    g = torch._standard_gamma(shape, generator=gen)
    s2 = post["c"] / g
    L = torch.linalg.cholesky(torch.linalg.inv(post["A"])).to(dev)
    z = torch.randn((C, 2), generator=gen, device=dev, dtype=torch.float64)
    b = post["b_hat"].to(dev) + (z @ L.T) * torch.sqrt(s2 / temper)[:, None]
    return torch.cat([b, torch.sqrt(s2)[:, None]], dim=1)


def log_density(x: torch.Tensor, y: torch.Tensor, theta: torch.Tensor,
                temper: float, block: int = 64) -> torch.Tensor:
    """log pi of each state of ``theta`` (m, 3) over every point, float64,
    ``block`` states at a time."""
    x, y = x.double(), y.double()
    n = x.shape[0]
    th = theta.to(x.device).double()
    out = []
    for s in range(0, th.shape[0], block):
        t = th[s:s + block]
        r = y[None, :] - t[:, 0:1] - t[:, 1:2] * x[None, :]
        rss = (r * r).sum(1)
        s2 = t[:, 2] * t[:, 2]
        out.append(temper * (-0.5 * n * (_LOG_2PI + torch.log(s2))
                             - rss / (2.0 * s2)))
    return torch.cat(out)


def _stats(x, y, dtype):
    x, y = x.double(), y.double()
    s = torch.stack([x.sum(), y.sum(), (x * x).sum(), (y * y).sum(),
                     (x * y).sum()])
    return s.to(dtype)


def pmp_chains(x, y, theta0: torch.Tensor, steps: int, gen: torch.Generator,
               *, depth: int, step_size: float, temper: float,
               dtype=torch.float32) -> tuple:
    """``steps`` supersteps of C chains from ``theta0`` (C, 3), everything
    in ``dtype`` (the data's five sums are formed in float64 and rounded
    to it).  Returns ``(draws (C, steps, 3), logp (C, steps))``: each
    superstep's new state and its log-density as the sampler computed it.

    A superstep: P = 2**depth positions Y[x] = theta + sum over levels i
    where bit i of x is set of eps[x mod 2**(i+1)], eps ~ N(0, step^2);
    log A[x] = sum_i log sigmoid(lp[a] - lp[a ^ 2**i]), a = x mod
    2**(i+1) (the Barker walk); the next state is one draw of x with
    probability proportional to exp(log A)."""
    dev = gen.device
    n = x.shape[0]
    st = _stats(x, y, dtype).to(dev)
    sx, sy, sxx, syy, sxy = st
    P = 2 ** depth
    node = torch.arange(P, device=dev)
    theta = theta0.to(device=dev, dtype=dtype)
    C = theta.shape[0]
    draws = torch.empty((C, steps, 3), dtype=dtype, device=dev)
    logps = torch.empty((C, steps), dtype=dtype, device=dev)
    half_log2pi = torch.tensor(0.5 * n * _LOG_2PI, dtype=dtype, device=dev)
    for t in range(steps):
        eps = step_size * torch.randn((C, P, 3), generator=gen, device=dev,
                                      dtype=torch.float32).to(dtype)
        Y = theta[:, None, :].expand(C, P, 3)
        for i in range(depth):
            born = ((node >> i) & 1).to(dtype)[None, :, None]
            Y = Y + born * eps[:, node % (2 ** (i + 1)), :]
        b0, b1, sg = Y[..., 0], Y[..., 1], Y[..., 2]
        rss = (syy + n * b0 * b0 + b1 * b1 * sxx + 2.0 * b0 * b1 * sx
               - 2.0 * b0 * sy - 2.0 * b1 * sxy)
        s2 = sg * sg
        lp = temper * (-half_log2pi - 0.5 * n * torch.log(s2)
                       - rss / (2.0 * s2))
        logA = torch.zeros_like(lp)
        for i in range(depth):
            a = node % (2 ** (i + 1))
            logA = logA + torch.nn.functional.logsigmoid(
                lp[:, a] - lp[:, a ^ (2 ** i)])
        w = torch.softmax(logA, dim=1)
        cdf = torch.cumsum(w, dim=1)
        u = torch.rand((C, 1), generator=gen, device=dev).to(dtype)
        k = torch.clamp((cdf < u * cdf[:, -1:]).sum(1), max=P - 1)
        theta = Y[torch.arange(C, device=dev), k]
        draws[:, t] = theta
        logps[:, t] = lp[torch.arange(C, device=dev), k]
    return draws, logps
