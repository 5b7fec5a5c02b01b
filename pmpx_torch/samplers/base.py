"""Sampler core: target protocol, batched evaluation, chain runner (port of
``pmpx/samplers/base.py``).

A superstep is a function ``(generator, state) -> (state', out)``; a chain
is a Python loop over supersteps (see :func:`run_chain` for the design).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Protocol, runtime_checkable

import torch

__all__ = ["Target", "Tempered", "batch_log_prob", "run_chain"]


@runtime_checkable
class Target(Protocol):
    """A sampling target: unnormalized log-density over flat R^d states.

    Implementations may additionally provide
    ``log_prob_batch(Theta: (P, d)) -> (P,)`` (preferred over a loop of
    ``log_prob`` when present) and ``value_and_grad_batch``.
    """

    d: int

    def log_prob(self, theta: torch.Tensor) -> torch.Tensor: ...


def batch_log_prob(
    target: Target,
    Theta: torch.Tensor,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Evaluate the log-density of all rows of ``Theta`` (P, d) -> (P,).

    Stochastic targets (``needs_rng = True``) receive ``generator``.
    """
    fused = getattr(target, "log_prob_batch", None)
    if getattr(target, "needs_rng", False):
        if fused is not None:
            return fused(Theta, generator=generator)
        return torch.stack(
            [target.log_prob(t, generator=generator) for t in Theta]
        )
    if fused is not None:
        return fused(Theta)
    return torch.stack([target.log_prob(t) for t in Theta])


class Tempered:
    """Scale a target's log-density by ``beta`` (the reference's
    likelihood-tempering divisors as explicit config).  Forwards
    ``needs_rng`` and any ``value_and_grad_batch`` of the wrapped target.
    """

    def __init__(self, target: Target, beta: float):
        self.inner = target
        self.beta = float(beta)
        self.d = target.d
        self.needs_rng = bool(getattr(target, "needs_rng", False))
        if hasattr(target, "value_and_grad_batch"):
            if self.needs_rng:
                def vgb(Theta, generator=None):
                    v, g = target.value_and_grad_batch(
                        Theta, generator=generator
                    )
                    return self.beta * v, self.beta * g
            else:
                def vgb(Theta):
                    v, g = target.value_and_grad_batch(Theta)
                    return self.beta * v, self.beta * g
            self.value_and_grad_batch = vgb

    def log_prob(self, theta, generator=None):
        if self.needs_rng:
            return self.beta * self.inner.log_prob(theta, generator=generator)
        return self.beta * self.inner.log_prob(theta)

    def log_prob_batch(self, Theta, generator=None):
        return self.beta * batch_log_prob(self.inner, Theta, generator)


def _stack(recs: list):
    first = recs[0]
    if isinstance(first, dict):
        return {k: _stack([r[k] for r in recs]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack(list(col)) for col in zip(*recs))
    return torch.stack(recs)


def _print_step(step: int, state, out) -> None:
    print(f"[pmpx_torch] step {step}")


def run_chain(
    superstep: Callable[[torch.Generator, Any], tuple],
    generator: torch.Generator,
    state0: Any,
    num_steps: int,
    collect: Optional[Callable[[Any, Any], Any]] = None,
    log_every: Optional[int] = None,
    log_fn: Optional[Callable[[int, Any, Any], None]] = None,
):
    """Run ``num_steps`` supersteps; returns ``(final_state, records)``.

    ``superstep(generator, state) -> (state', out)``; ``collect(state',
    out)`` chooses what to record per step (defaults to ``out``).  Records
    are stacked along a new leading axis, through dicts and tuples.

    ``log_every``/``log_fn``: opt-in host observability, off by default.
    With ``log_every`` set, ``log_fn(step, state', out)`` runs on the host
    after every step with ``step % log_every == 0`` (the default prints
    the step); whatever it reads from the device syncs the loop there.

    Design.  ``pmpx`` scans the superstep under one ``jit``, splitting one
    PRNG key per step.  Here the loop is Python, and it stays on the
    device: every step enqueues its kernels on the current stream and
    nothing reads a value back to the host (no ``.item()``, no branch on
    device data), so the host runs ahead of the card and the loop's only
    synchronization is the caller's.  The randomness is one explicit
    ``torch.Generator`` on the chain's device, threaded through every
    superstep; its draws advance its Philox offset, so a chain is
    reproducible from the generator's seed.  The stream differs from
    ``jax.random``'s: tests that compare the two inject the same noise
    into each superstep.  Checkpoint/resume (:mod:`pmpx_torch.checkpoint`)
    saves the generator's state (``get_state``) beside the chain state at
    each chunk boundary and restores it (``set_state``) on resume; the
    state is not derived from the step.  So chunks of ``run_chain``, with
    or without a resume between them, draw what one ``run_chain`` of the
    same seed and total step count draws, and give the same chain bit for
    bit.
    """
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    state = state0
    recs = []
    for step in range(num_steps):
        state, out = superstep(generator, state)
        if log_every and step % log_every == 0:
            (log_fn or _print_step)(step, state, out)
        recs.append(collect(state, out) if collect is not None else out)
    return state, _stack(recs)
