"""The linreg configurations on both sides: the inputs from the seed (the
reference's law), the program's target and sampler over them, and the
numbers that decide ``correct`` for what a run produced."""

from __future__ import annotations

import torch

from benchmark.reference import checks
from benchmark.reference import linreg as ref

__all__ = ["inputs", "program_target", "sampler_config", "program_chain",
           "check", "control"]


def inputs(config: dict, seed: int, device) -> dict:
    x, y = ref.make_data(seed, config["n_data"], device)
    theta0 = torch.tensor(config["theta0"], dtype=torch.float32,
                          device=device)
    return {"x": x, "y": y, "theta0": theta0}


def program_target(config: dict, inp: dict, device):
    """The program's posterior over the run's data; ``method="sweep"``
    evaluates every point at every proposal (the fused kernels read the
    data grids themselves)."""
    from pmpx_torch.targets.linreg import BayesLinReg

    return BayesLinReg(inp["x"], inp["y"], temper=config["temper"],
                       method="sweep", device=device)


def sampler_config(config: dict):
    from pmpx_torch.samplers.pmp import PMPConfig

    return PMPConfig(**config["sampler"])


def program_chain(config: dict, inp: dict, device) -> tuple:
    """(superstep, first state) of the generic PMP superstep."""
    from pmpx_torch.samplers import pmp

    target = program_target(config, inp, device)
    return pmp.make_superstep(target, sampler_config(config)), inp["theta0"]


def check(config: dict, traffic: dict, inp: dict, out: dict,
          gen: torch.Generator) -> dict:
    """``moment_z`` of the window's draws against the exact posterior, and
    with the program's log-densities ``logp_gap`` over a sample of
    ``traffic["check_states"]`` states drawn with ``gen``."""
    post = ref.exact_posterior(inp["x"], inp["y"], config["temper"])
    draws = out["draws"]
    numbers = {"moment_z": checks.moment_z(draws, post["mean"],
                                           post["var"])["value"]}
    if "logp" in out:
        flat = draws.reshape(-1, 3)
        m = min(traffic["check_states"], flat.shape[0])
        idx = torch.randperm(flat.shape[0], generator=gen,
                             device=gen.device)[:m].to(flat.device)
        want = ref.log_density(inp["x"], inp["y"], flat[idx],
                               config["temper"])
        numbers["logp_gap"] = checks.logp_gap(out["logp"].reshape(-1)[idx],
                                              want)
    return numbers


def control(config: dict, traffic: dict, inp: dict, gen: torch.Generator,
            check_gen: torch.Generator) -> dict:
    """The check's numbers with the reference's sampler in bfloat16 in the
    program's place: ``traffic["control"]`` chains and supersteps from
    exact posterior draws (no burn-in to leave), over the run's data."""
    temper, s = config["temper"], config["sampler"]
    post = ref.exact_posterior(inp["x"], inp["y"], temper)
    C, T = traffic["control"]["chains"], traffic["control"]["steps"]
    th0 = ref.posterior_draws(post, temper, C, gen).float()
    draws, logp = ref.pmp_chains(inp["x"], inp["y"], th0, T, gen,
                                 depth=s["depth"], step_size=s["step_size"],
                                 temper=temper, dtype=torch.bfloat16)
    out = {"draws": draws.float(), "first": th0}
    if traffic["path"] == "compiled_chain":
        out["logp"] = logp.float()
    return check(config, traffic, inp, out, check_gen)
