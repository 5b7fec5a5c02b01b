"""Mean-field Bayesian MLP with torchbnn-style BayesLinear layers (port of
``pmpx/models/bnn.py``).

Parity with the reference BNN (``Bayesian Network Training/main.py:173-177``:
torchbnn ``BayesLinear(prior_mu=0, prior_sigma=0.1, 784, 1024)`` + ReLU +
``BayesLinear(1024, 10)``).  Each layer's parameters are ``w_mu``,
``w_log_sigma``, ``b_mu`` and ``b_log_sigma`` (flax's tree, ``pmpx``'s
ravel order); every forward pass draws fresh weights ``W = mu +
exp(log_sigma) * eps``.  The chain state is the (mu, log_sigma) vector.

The noise ``eps`` is an argument of :meth:`BayesMLP.forward`, drawn by the
caller from its explicit generator (:meth:`BayesMLP.noise_shapes` gives
the shapes): a random op under ``torch.func.vmap`` cannot take that
generator, so the posterior draws a (P, ...) batch of noise outside the
vmap and passes it in batched.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["BayesLinear", "BayesMLP"]


class BayesLinear(nn.Module):
    """Parameters ``w_mu``/``w_log_sigma`` (in, out), ``b_mu``/
    ``b_log_sigma`` (out); ``w_mu`` kaiming-uniform, the log-sigmas
    ``log(prior_sigma)``, ``b_mu`` zero."""

    def __init__(self, d_in: int, d_out: int, prior_sigma: float = 0.1):
        super().__init__()
        self.prior_sigma = prior_sigma
        self.w_mu = nn.Parameter(torch.zeros(d_in, d_out))
        self.w_log_sigma = nn.Parameter(torch.zeros(d_in, d_out))
        self.b_mu = nn.Parameter(torch.zeros(d_out))
        self.b_log_sigma = nn.Parameter(torch.zeros(d_out))

    def forward(self, x, eps_w, eps_b):
        W = self.w_mu + torch.exp(self.w_log_sigma) * eps_w
        b = self.b_mu + torch.exp(self.b_log_sigma) * eps_b
        return x @ W + b


class BayesMLP(nn.Module):
    def __init__(self, hidden: int = 1024, num_classes: int = 10,
                 prior_sigma: float = 0.1, d_in: int = 28 * 28):
        super().__init__()
        self.BayesLinear_0 = BayesLinear(d_in, hidden, prior_sigma)
        self.BayesLinear_1 = BayesLinear(hidden, num_classes, prior_sigma)

    def flax_layout(self) -> list:
        """(flax path, shape, initialiser) in ``ravel_pytree``'s order:
        each layer's ``b_log_sigma``, ``b_mu``, ``w_log_sigma``,
        ``w_mu``."""
        out = []
        for name, mod in sorted(self.named_children()):
            ls = f"const:{math.log(mod.prior_sigma)!r}"
            init = {"b_log_sigma": ls, "b_mu": "zeros", "w_log_sigma": ls,
                    "w_mu": "kaiming_uniform"}
            for leaf, p in sorted(mod.named_parameters()):
                out.append((f"{name}.{leaf}", tuple(p.shape), init[leaf]))
        return out

    def noise_shapes(self) -> dict:
        """{name: shape} of the noise one forward pass takes, in the order
        it is drawn."""
        out = {}
        for name, mod in self.named_children():
            out[f"{name}.w"] = tuple(mod.w_mu.shape)
            out[f"{name}.b"] = tuple(mod.b_mu.shape)
        return out

    def forward(self, x: torch.Tensor, noise: dict) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(self.BayesLinear_0(
            x, noise["BayesLinear_0.w"], noise["BayesLinear_0.b"]))
        return self.BayesLinear_1(
            x, noise["BayesLinear_1.w"], noise["BayesLinear_1.b"])
