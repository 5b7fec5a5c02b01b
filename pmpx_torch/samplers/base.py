"""Sampler core: target protocol, batched evaluation, chain runner (port of
``pmpx/samplers/base.py``).

A superstep is a function ``(generator, state) -> (state', out)``.  On a
CUDA device a chain replays a captured CUDA graph of ``unroll``
supersteps (by default as many as the superstep's own card time calls
for), PyTorch's counterpart of ``pmpx``'s ``lax.scan`` under one
``jit``; on the CPU it is a Python loop over supersteps (see
:func:`run_chain` for the design).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional, Protocol, runtime_checkable

import torch

from pmpx_torch.kernels import launches
from pmpx_torch.profiling import counters, span

__all__ = ["CompiledChain", "Target", "Tempered", "batch_log_prob",
           "compile_chain", "declare_eager", "eager_reason", "run_chain",
           "run_chain_eager", "unroll_for"]


@runtime_checkable
class Target(Protocol):
    """A sampling target: unnormalized log-density over flat R^d states.

    Implementations may additionally provide
    ``log_prob_batch(Theta: (P, d)) -> (P,)`` (preferred over a loop of
    ``log_prob`` when present) and ``value_and_grad_batch``.  A target
    whose evaluation cannot run inside a CUDA graph (it issues
    collectives) says why in its ``eager_only`` attribute; the supersteps
    built over it inherit the declaration (:func:`declare_eager`).
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
    ``needs_rng``, ``eager_only`` and any ``value_and_grad_batch`` of the
    wrapped target.
    """

    def __init__(self, target: Target, beta: float):
        self.inner = target
        self.beta = float(beta)
        self.d = target.d
        self.needs_rng = bool(getattr(target, "needs_rng", False))
        self.eager_only = getattr(target, "eager_only", None)
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


def declare_eager(superstep: Callable, reason: Optional[str]) -> Callable:
    """Mark ``superstep`` as one that :func:`run_chain` must not capture
    (``reason`` says why, e.g. its target issues collectives), or, with
    ``reason=None``, as capturable; returns it.  The supersteps' makers
    pass on their target's ``eager_only``."""
    superstep.eager_only = reason
    return superstep


def eager_reason(superstep: Callable, state: Any = None) -> Optional[str]:
    """Why :func:`run_chain` runs ``superstep`` from ``state`` as the
    eager loop, or None when it replays a CUDA graph: the superstep's
    declaration, or a state with no leaf on a CUDA device.  Raises
    ValueError on a state that mixes CUDA tensors with others."""
    on_cuda = None
    if state is not None:
        on_cuda = [isinstance(t, torch.Tensor) and t.is_cuda
                   for t in _leaves(state)]
        if any(on_cuda) and not all(on_cuda):
            raise ValueError(
                f"the state of {_name(superstep)} mixes CUDA tensors with "
                "others; a chain's state lies on one device")
    declared = getattr(superstep, "eager_only", None)
    if declared:
        return declared
    if on_cuda is not None and not any(on_cuda):
        return "the state is not on a CUDA device"
    return None


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure with the leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_rebuild(v, leaves) for v in tree)
    if isinstance(tree, list):
        return [_rebuild(v, leaves) for v in tree]
    return next(leaves)


def _clone(tree):
    return _rebuild(tree, (t.clone() for t in _leaves(tree)))


def _stack(recs: list):
    first = recs[0]
    if isinstance(first, dict):
        return {k: _stack([r[k] for r in recs]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack(list(col)) for col in zip(*recs))
    return torch.stack(recs)


def _print_step(step: int, state, out) -> None:
    print(f"[pmpx_torch] step {step}")


def _name(fn) -> str:
    return (f"{getattr(fn, '__module__', '?')}."
            f"{getattr(fn, '__qualname__', type(fn).__name__)}")


def _layout(tree):
    if isinstance(tree, dict):
        return ("d", tuple((k, _layout(v)) for k, v in tree.items()))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(_layout(v) for v in tree))
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"a chain state holds tensors, not {type(tree)!r}")
    return (tuple(tree.shape), tree.dtype, tree.device)


def _plan(start: int, num_steps: int, unroll: int,
          log_every: Optional[int]) -> list:
    """Steps per replay from step ``start``: ``unroll`` each, and one
    where fewer are left before the end or before the next step
    ``log_fn`` sees (a segment ends at each)."""
    plan, pos = [], start
    while pos < num_steps:
        end = num_steps
        if log_every:
            end = min(end, -(-pos // log_every) * log_every + 1)
        k = unroll if end - pos >= unroll else 1
        plan.append(k)
        pos += k
    return plan


# A chain that chooses its unroll covers at most REPLAY_US µs of card time
# and MAX_UNROLL supersteps a replay: the host's per-replay cost (graph
# launch, record copies, the generator's fills; tens of µs) then keeps
# off the card's critical path, and a long superstep keeps the one-step
# graph alone.
REPLAY_US = 2000.0
MAX_UNROLL = 64
# one-step replays timed in the first run, after one untimed (the graph's
# first launch uploads it)
TIMED_REPLAYS = 4
# the spin that holds the stream while the host queues the timed replays,
# so that the events read the card's time and not the host's (~1-2 ms)
_HOLD_CYCLES = 2_000_000


def unroll_for(t1_us: float, num_steps: int) -> int:
    """The supersteps a replay covers for a superstep of ``t1_us`` µs of
    card time, in a chain whose first run has ``num_steps``: the largest
    power of two k <= MAX_UNROLL and <= num_steps with k * t1_us <=
    REPLAY_US, and 1 where none is."""
    k = 1
    while (2 * k <= min(MAX_UNROLL, num_steps)
           and 2 * k * t1_us <= REPLAY_US):
        k *= 2
    return k


class _Chunk:
    """``steps`` supersteps from the chain's static state: a captured
    CUDA graph, or (``graph=None``) the same body run eagerly each time.
    ``recs`` and ``last`` are its static outputs, ``counts`` the kernel
    launches one replay makes."""

    def __init__(self, graph, recs=None, last=None, counts=None):
        self.graph, self.recs, self.last = graph, recs, last
        self.counts = counts or {}


class CompiledChain:
    """The compiled chain of one superstep, ``collect``, ``unroll`` and
    state layout (:func:`compile_chain` builds it).

    ``run(generator, state0, num_steps, log_every=None, log_fn=None)`` is
    :func:`run_chain` on it.  The first run runs step 0 eagerly (lazy
    initialisation and the kernels' build happen outside any graph) and
    keeps its record, then captures a graph of ``unroll`` supersteps and
    one of one (the tail, and the segments ``log_every`` cuts) in the
    first one's memory pool.  With ``unroll=None`` the chain chooses: its
    first run captures the one-step graph, times up to
    :data:`TIMED_REPLAYS` of its own one-step replays on the card with one
    pair of CUDA events (one sync), sets ``unroll`` by :func:`unroll_for`
    and, where that is more than 1, captures that graph in the same pool
    for the rest of the run.  Every later run only replays, so a
    timed window that follows a first run holds no capture.  The state
    lives in static tensors; each graph's last node copies its new state
    back into them, so replays chain.  The chain draws from a generator
    of its own, registered with both graphs before capture: a run copies
    the caller's generator state in and the advanced state back out (host
    bytes, no sync).  It runs on the caller's stream: a side stream could
    not reuse the blocks the caching allocator holds for the caller's,
    and a full-width NN step would need its peak twice.  The graphs and
    their pool live as long as the chain.

    A superstep that :func:`eager_reason` gives a reason for runs as
    :func:`run_chain_eager` at each run.  ``capture=False`` runs each
    chunk's body eagerly instead of replaying it (the CPU tests of the
    runner).  Both take ``unroll=None`` as 1.

    A run is the span ``chain.run`` (:mod:`pmpx_torch.profiling`), which
    holds ``chain.capture`` (the first run's step 0 and captures, whose
    host seconds every run adds to ``counters["capture_s"]``), one
    ``chain.replay`` a replay (``steps`` its supersteps) and one
    ``chain.records`` for each copy of records into the outputs.  The
    always-on counters ``replays`` and ``replayed_supersteps`` add each
    chunk run and its supersteps.
    """

    def __init__(self, superstep, generator, state_like, collect=None,
                 unroll: Optional[int] = None, *, capture: bool = True):
        if unroll is not None and unroll < 1:
            raise ValueError(f"unroll must be >= 1, got {unroll}")
        self.superstep, self.collect = superstep, collect
        self.reason = eager_reason(superstep, state_like) if capture else None
        self.capture = capture
        if unroll is None and (self.reason is not None or not capture):
            unroll = 1
        self.unroll = unroll
        if self.reason is not None:
            return
        self.layout = _layout(state_like)
        leaves = _leaves(state_like)
        self.tree = _rebuild(state_like, iter([None] * len(leaves)))
        self.static = [torch.empty_like(t) for t in leaves]
        self.gen = (None if generator is None
                    else torch.Generator(device=generator.device))
        self.chunks: dict = {}
        self.pool = None

    def _state(self):
        return _rebuild(self.tree, iter(self.static))

    def _store(self, state) -> None:
        new = _leaves(state)
        if len(new) != len(self.static):
            raise ValueError(f"{_name(self.superstep)} returned a state "
                             "of another structure")
        for dst, src in zip(self.static, new):
            dst.copy_(src)

    def _body(self, steps: int):
        state = self._state()
        recs = []
        for _ in range(steps):
            state, out = self.superstep(self.gen, state)
            recs.append(out if self.collect is None
                        else self.collect(state, out))
        stacked = _stack(recs)
        self._store(state)
        return stacked, out

    def _first_step(self):
        """Step 0 run eagerly; returns its (out, record)."""
        state, out = self.superstep(self.gen, self._state())
        rec = out if self.collect is None else self.collect(state, out)
        self._store(state)
        return out, rec

    def _compile(self) -> None:
        for steps in sorted({self.unroll or 1, 1}, reverse=True):
            self.chunks[steps] = self._capture(steps)

    def _card_us(self, replay, n: int, dev) -> float:
        """The mean card µs of the next ``n`` one-step replays (``replay(1)``
        each): the stream held by a spin while the host queues them, one
        pair of events around them, one sync."""
        stream = torch.cuda.current_stream(dev)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with torch.cuda.device(dev):
            torch.cuda._sleep(_HOLD_CYCLES)
        start.record(stream)
        for _ in range(n):
            replay(1)
        end.record(stream)
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / n

    def _choose(self, replay, left: int, num_steps: int, dev) -> None:
        """The first run's choice of ``unroll``, from the one-step replays
        it has ``left`` (one untimed, then up to TIMED_REPLAYS timed), and
        the capture of its graph."""
        k = 1
        if left > 0:
            if left > 1:
                replay(1)
            n = min(TIMED_REPLAYS, left - 1) or 1
            k = unroll_for(self._card_us(replay, n, dev), num_steps)
        self.unroll = k
        if k > 1:
            t0 = time.perf_counter()
            with span("chain.capture", dev):
                self.chunks[k] = self._capture(k)
            counters["capture_s"] += time.perf_counter() - t0

    def _capture(self, steps: int) -> _Chunk:
        if not self.capture:
            return _Chunk(None)
        before = dict(launches)
        graph = torch.cuda.CUDAGraph()
        if self.gen is not None:
            graph.register_generator_state(self.gen)
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                recs, last = self._body(steps)
            counts = {k: launches[k] - before[k] for k in launches
                      if launches[k] != before[k]}
        except Exception as e:
            raise RuntimeError(
                f"run_chain: cannot capture the superstep "
                f"{_name(self.superstep)} in a CUDA graph "
                f"({type(e).__name__}: {e}); a superstep that cannot run "
                "in a graph declares so with declare_eager") from e
        finally:
            launches.update(before)  # the capture launches nothing
        if self.pool is None:
            self.pool = graph.pool()
        return _Chunk(graph, recs, last, counts)

    def run(self, generator, state0, num_steps: int,
            log_every: Optional[int] = None,
            log_fn: Optional[Callable[[int, Any, Any], None]] = None):
        if num_steps < 1:
            raise ValueError(f"num_steps must be >= 1, got {num_steps}")
        if self.reason is not None:
            return run_chain_eager(self.superstep, generator, state0,
                                   num_steps, self.collect, self.unroll,
                                   log_every, log_fn)
        if _layout(state0) != self.layout:
            raise ValueError(f"the chain of {_name(self.superstep)} was "
                             "compiled for another state layout")
        dev = self.static[0].device if self.static else None
        with span("chain.run", dev, steps=num_steps):
            return self._run(generator, state0, num_steps, log_every,
                             log_fn, dev)

    def _run(self, generator, state0, num_steps, log_every, log_fn, dev):
        for dst, src in zip(self.static, _leaves(state0)):
            dst.copy_(src)
        if generator is not None:
            self.gen.set_state(generator.get_state())
        log = log_fn or _print_step
        first, start = None, 0
        if not self.chunks:
            t0 = time.perf_counter()
            with span("chain.capture", dev):
                first, start = self._first_step(), 1
                if log_every:
                    log(0, _clone(self._state()), _clone(first[0]))
                self._compile()
            counters["capture_s"] += time.perf_counter() - t0
        outs = tree = None
        if first is not None:
            tree = first[1]
            with span("chain.records", dev):
                outs = [torch.empty((num_steps, *r.shape), dtype=r.dtype,
                                    device=r.device) for r in _leaves(tree)]
                for dst, src in zip(outs, _leaves(tree)):
                    dst[0].copy_(src)
        pos = start

        def replay(k):
            nonlocal outs, tree, pos
            chunk = self.chunks[k]
            with span("chain.replay", dev, steps=k):
                if chunk.graph is None:
                    chunk.recs, chunk.last = self._body(k)
                else:
                    chunk.graph.replay()
                    for name, n in chunk.counts.items():
                        launches[name] += n
            counters["replays"] += 1
            counters["replayed_supersteps"] += k
            leaves = _leaves(chunk.recs)
            with span("chain.records", dev):
                if outs is None:
                    tree = chunk.recs
                    outs = [torch.empty((num_steps, *r.shape[1:]),
                                        dtype=r.dtype, device=r.device)
                            for r in leaves]
                for dst, src in zip(outs, leaves):
                    dst[pos:pos + k].copy_(src)
            pos += k
            if log_every and (pos - 1) % log_every == 0:
                log(pos - 1, _clone(self._state()), _clone(chunk.last))

        if self.unroll is None:
            self._choose(replay, num_steps - pos, num_steps, dev)
        for k in _plan(pos, num_steps, self.unroll, log_every):
            replay(k)
        if generator is not None:
            generator.set_state(self.gen.get_state())
        final = _rebuild(self.tree, (t.clone() for t in self.static))
        return final, _rebuild(tree, iter(outs))


def compile_chain(
    superstep: Callable[[torch.Generator, Any], tuple],
    generator: Optional[torch.Generator],
    state_like: Any,
    collect: Optional[Callable[[Any, Any], Any]] = None,
    unroll: Optional[int] = None,
) -> CompiledChain:
    """The chain of ``superstep`` from states laid out as ``state_like``
    and generators on ``generator``'s device, to run many times
    (:class:`CompiledChain`): its first run captures (and, with ``unroll``
    None, chooses the supersteps a replay covers), later runs only
    replay.  Timed code makes the first run before its window;
    :func:`pmpx_torch.checkpoint.resume_chain` runs every chunk on one."""
    return CompiledChain(superstep, generator, state_like, collect, unroll)


def run_chain(
    superstep: Callable[[torch.Generator, Any], tuple],
    generator: torch.Generator,
    state0: Any,
    num_steps: int,
    collect: Optional[Callable[[Any, Any], Any]] = None,
    unroll: Optional[int] = None,
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
    the step); whatever it reads from the device syncs the chain there.

    Design.  ``pmpx`` scans the superstep under one ``jit``, splitting one
    PRNG key per step, with ``unroll`` supersteps a loop iteration.  Here,
    on a CUDA device, step 0 runs eagerly, then ``unroll`` supersteps are
    captured once into a CUDA graph and replayed until ``num_steps`` (a
    one-step graph takes the tail that ``unroll`` does not divide).  With
    ``unroll=None`` (the default) the chain sets it from its first
    one-step replays' card time (:class:`CompiledChain`,
    :func:`unroll_for`): a replay covers up to ``REPLAY_US`` of card time,
    so a short superstep's host cost a replay (the launch, the records'
    copies) is spread over many, and a long one keeps one-step replays.  The
    state is copied into static tensors that each replay reads and
    overwrites; each replay's stacked records are copied into the run's
    ``(num_steps, ...)`` buffers on the device.  Nothing reads a value
    back to the host, so the host runs ahead of the card and the chain's
    only synchronization is the caller's.  Each call compiles its own
    chain (:class:`CompiledChain`), freed when it returns; a caller that
    runs one chain many times, or times it, compiles it once with
    :func:`compile_chain`.  ``kernels.launches`` counts step 0's launches
    and each replay's (the capture counts none).

    The randomness is one explicit ``torch.Generator`` on the chain's
    device, threaded through every superstep; its draws advance its
    Philox offset, so a chain is reproducible from the generator's seed.
    A captured op takes the offset it would take eagerly, so the records,
    the final state and the generator's state equal those of
    :func:`run_chain_eager` bit for bit.  The stream differs from
    ``jax.random``'s: tests that compare the two inject the same noise
    into each superstep.  Checkpoint/resume (:mod:`pmpx_torch.checkpoint`)
    saves the generator's state (``get_state``) beside the chain state at
    each chunk boundary and restores it (``set_state``) on resume; the
    state is not derived from the step.  So chunks of ``run_chain``, with
    or without a resume between them, draw what one ``run_chain`` of the
    same seed and total step count draws, and give the same chain bit for
    bit.

    The eager loop runs where :func:`eager_reason` gives a reason: on the
    CPU, and for a superstep declared uncapturable (:func:`declare_eager`).
    A state that mixes devices raises ValueError, and any other failure to
    capture raises RuntimeError naming the superstep; nothing falls back.
    """
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    return compile_chain(superstep, generator, state0, collect, unroll).run(
        generator, state0, num_steps, log_every, log_fn)


def run_chain_eager(
    superstep: Callable[[torch.Generator, Any], tuple],
    generator: torch.Generator,
    state0: Any,
    num_steps: int,
    collect: Optional[Callable[[Any, Any], Any]] = None,
    unroll: Optional[int] = None,
    log_every: Optional[int] = None,
    log_fn: Optional[Callable[[int, Any, Any], None]] = None,
):
    """:func:`run_chain`'s plain version: a Python loop that launches
    every superstep's kernels from the host (``unroll`` changes nothing
    here).  The CPU path, and the oracle of the captured chain.  Its spans
    are :class:`CompiledChain`'s, with a ``chain.replay`` a superstep and
    one ``chain.records`` for the stacking of the records."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    dev = next((t.device for t in _leaves(state0)
                if isinstance(t, torch.Tensor)), None)
    with span("chain.run", dev, steps=num_steps):
        state = state0
        recs = []
        for step in range(num_steps):
            with span("chain.replay", dev, steps=1):
                state, out = superstep(generator, state)
            if log_every and step % log_every == 0:
                (log_fn or _print_step)(step, state, out)
            recs.append(collect(state, out) if collect is not None else out)
        with span("chain.records", dev):
            return state, _stack(recs)
