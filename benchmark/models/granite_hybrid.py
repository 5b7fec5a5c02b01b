"""The granite-4.0-h-micro configuration on both sides: tokens and first
state from the seed (the reference's law), the program's posterior through
``GraniteHybridLM``'s batched density and its PMP superstep, the numbers
that decide ``correct`` for what a run produced, and the faults and the
control that those numbers must catch.

Faults (:data:`FAULTS`), each a program broken underneath:

* ``no_d_skip``: the scan without its D skip;
* ``no_decay``: exp(dt * A) taken as 1 (A = 0);
* ``no_causal_mask``: the attention sees the whole sequence;
* ``half_tokens``: the program scores the first half of the sequences
  twice and never the rest;
* ``stuck``: the superstep returns its state unchanged.

The control (:func:`control`) is the program's own forward in a precision
below the configuration's bfloat16: every product's operands rounded
through float8 e4m3 (cast and cast back), the scan's too, and the scan's
state held in bfloat16 between chunks.
"""

from __future__ import annotations

import torch

from benchmark.reference import checks
from benchmark.reference import granite_hybrid as ref

__all__ = ["inputs", "program_chain", "posterior", "check", "control",
           "faulty_chain", "fault_ops", "FAULTS", "COLLECT"]

# each superstep's outputs the check reads besides its state and root_logp
COLLECT = ("log_accept", "root_index")
FAULTS = ("no_d_skip", "no_decay", "no_causal_mask", "half_tokens", "stuck")
# parameters above which the configuration runs only on a card
CPU_PARAMS = 50_000_000


def inputs(config: dict, seed: int, device) -> dict:
    if torch.device(device).type != "cuda" and config["params"] > CPU_PARAMS:
        raise ValueError(f"{config['params']:,} parameters run on a card "
                         "only; rehearse on the CPU with a tiny config")
    return {"tokens": ref.make_tokens(seed, config, device),
            "theta0": ref.init_theta(seed + 1, config, device)}


def posterior(config: dict, inp: dict, device, ops=None):
    """The program's posterior over the run's tokens in the
    configuration's dtype, its density through the batched pass
    (``ops``: what it computes with, the program's own by default)."""
    from pmpx_torch.models import GraniteHybridLM, granite_hybrid
    from pmpx_torch.targets.nn import NNPosterior

    dtype = None if config["dtype"] == "float32" else getattr(
        torch, config["dtype"])
    tokens = inp["tokens"]
    target = NNPosterior(GraniteHybridLM(config), tokens[:, :-1],
                         tokens[:, 1:].reshape(-1), temper=config["temper"],
                         compute_dtype=dtype, device=device)
    if target.d != config["params"]:
        raise ValueError(f"the program's posterior has {target.d} "
                         f"parameters, the configuration {config['params']}")
    granite_hybrid.attach(target, ops or granite_hybrid.OPS)
    return target


def _spec(config: dict):
    from pmpx_torch.config import SamplerSpec

    s = config["sampler"]
    return SamplerSpec.reference_nn(
        s["algo"], s["N"], step_size=s["step_size"],
        selection=s["selection"], stabilizer=s["stabilizer"])


def _chain(config: dict, inp: dict, device, ops=None) -> tuple:
    target = posterior(config, inp, device, ops)
    return _spec(config).build(target), inp["theta0"]


def program_chain(config: dict, inp: dict, device) -> tuple:
    """(superstep, first state) under the reference's PMP protocol."""
    return _chain(config, inp, device)


def fault_ops(fault: str):
    """The program's ops with ``fault`` (one of the forward's faults)."""
    from pmpx_torch.models import granite_hybrid as gh

    ops = gh.OPS
    if fault == "no_d_skip":
        return ops._replace(ssd=lambda x, dt, A, B, C, D: ops.ssd(
            x, dt, A, B, C, torch.zeros_like(D)))
    if fault == "no_decay":
        return ops._replace(ssd=lambda x, dt, A, B, C, D: ops.ssd(
            x, dt, torch.zeros_like(A), B, C, D))
    if fault == "no_causal_mask":
        return ops._replace(attention=lambda q, k, v, scale: (
            gh.causal_attention(q, k, v, scale, causal=False)))
    raise ValueError(f"{fault!r} is not a fault of the forward")


def _half(tokens: torch.Tensor) -> torch.Tensor:
    h = tokens.shape[0] // 2
    return torch.cat([tokens[:h], tokens[:h], tokens[2 * h:]])


def faulty_chain(config: dict, inp: dict, device, fault: str) -> tuple:
    """:func:`program_chain` with ``fault`` (one of :data:`FAULTS`)."""
    if fault == "half_tokens":
        return _chain(config, dict(inp, tokens=_half(inp["tokens"])), device)
    if fault == "stuck":
        superstep, theta0 = _chain(config, inp, device)

        def stuck(generator, theta):
            _, out = superstep(generator, theta)
            return theta.clone(), out

        return stuck, theta0
    return _chain(config, inp, device, fault_ops(fault))


def check(config: dict, traffic: dict, inp: dict, out: dict,
          gen: torch.Generator) -> dict:
    """``logp_gap`` of the program's log-density of the full states the
    path kept (the window's last among them) against the reference's;
    over every superstep of the window ``stay_share`` on the watched
    coordinates, and ``select_z`` of the chosen slots against the
    selection law of the weights each superstep computed."""
    want = ref.log_density(out["states"], inp["tokens"], config)
    return {"logp_gap": checks.logp_gap(out["state_logp"], want),
            "stay_share": checks.stay_share(out["draws"][0], out["first"]),
            "select_z": checks.select_z(out["log_accept"][0],
                                        out["root_index"][0],
                                        config["sampler"]["stabilizer"])}


def _q8(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float8_e4m3fn).to(t.dtype)


def control_ops():
    """The program's ops a precision below bfloat16 (see the module's
    docstring)."""
    from pmpx_torch.kernels.mamba2_ssd import ssd_chunked_ref
    from pmpx_torch.models import granite_hybrid as gh

    return gh.Ops(
        mm=lambda a, b: torch.matmul(_q8(a), _q8(b)),
        ssd=lambda x, dt, A, B, C, D: ssd_chunked_ref(
            _q8(x), dt, A, _q8(B), _q8(C), D, state_dtype=torch.bfloat16),
        attention=lambda q, k, v, scale: gh.causal_attention(
            _q8(q), _q8(k), _q8(v), scale))


def logp_gaps(config: dict, inp: dict, states: list, device) -> dict:
    """``logp_gap`` over ``states`` of the program as it is, of each fault
    of the forward and of ``half_tokens``, and of the control, each
    evaluated one state at a time."""
    want = ref.log_density(states, inp["tokens"], config)
    variants = {"program": (inp, None), "control": (inp, control_ops()),
                "half_tokens": (dict(inp, tokens=_half(inp["tokens"])),
                                None)}
    for fault in ("no_d_skip", "no_decay", "no_causal_mask"):
        variants[fault] = (inp, fault_ops(fault))
    out = {}
    for name, (data, ops) in variants.items():
        target = posterior(config, data, device, ops)
        with torch.no_grad():
            got = torch.stack([target.log_prob_batch(s[None])[0]
                               for s in states])
        out[name] = checks.logp_gap(got, want)
        del target
    return out


def control(config: dict, traffic: dict, inp: dict, gen: torch.Generator,
            check_gen: torch.Generator) -> dict:
    """``logp_gap`` of the control at the first state and at a state one
    step of the sampler's random walk away."""
    theta0 = inp["theta0"]
    step = config["sampler"]["step_size"] * torch.randn(
        theta0.shape, generator=gen, device=theta0.device)
    states = [theta0, theta0 + step]
    want = ref.log_density(states, inp["tokens"], config)
    target = posterior(config, inp, theta0.device, control_ops())
    with torch.no_grad():
        got = torch.stack([target.log_prob_batch(s[None])[0]
                           for s in states])
    return {"logp_gap": checks.logp_gap(got, want)}
