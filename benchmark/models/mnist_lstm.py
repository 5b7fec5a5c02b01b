"""The MNIST-LSTM configuration on both sides: images and first state from
the seed (the reference's law), the program's posterior through
``lstm_fused`` and its PMP superstep, and the numbers that decide
``correct`` for what a run produced."""

from __future__ import annotations

import torch

from benchmark.reference import checks
from benchmark.reference import mnist_lstm as ref

__all__ = ["inputs", "program_chain", "check", "CONTROL_DTYPE", "COLLECT"]

# the control runs the program itself with its bfloat16 path on
CONTROL_DTYPE = "bfloat16"
# each superstep's outputs the check reads besides its state and root_logp
COLLECT = ("log_accept", "root_index")


def inputs(config: dict, seed: int, device) -> dict:
    X, Y = ref.make_images(seed, config, device)
    theta0 = ref.init_theta(seed + 1, config, device)
    return {"X": X, "Y": Y, "theta0": theta0}


def program_chain(config: dict, inp: dict, device) -> tuple:
    """(superstep, first state): the posterior over the run's images in
    the configuration's dtype, its density through the ``lstm_fused``
    kernel, under the reference's PMP protocol."""
    from pmpx_torch.config import SamplerSpec
    from pmpx_torch.kernels import lstm_fused
    from pmpx_torch.models import MnistLSTM
    from pmpx_torch.targets.nn import NNPosterior

    model = MnistLSTM(hidden=config["hidden"], num_classes=config["classes"],
                      steps=config["rows"], features=config["features"])
    dtype = None if config["dtype"] == "float32" else getattr(
        torch, config["dtype"])
    target = NNPosterior(model, inp["X"], inp["Y"], temper=config["temper"],
                         compute_dtype=dtype, device=device)
    if target.d != config["params"]:
        raise ValueError(f"the program's posterior has {target.d} "
                         f"parameters, the configuration {config['params']}")
    lstm_fused.attach(target)
    s = config["sampler"]
    spec = SamplerSpec.reference_nn(
        s["algo"], s["N"], step_size=s["step_size"],
        selection=s["selection"], stabilizer=s["stabilizer"])
    return spec.build(target), inp["theta0"]


def check(config: dict, traffic: dict, inp: dict, out: dict,
          gen: torch.Generator) -> dict:
    """``logp_gap`` of the program's log-density of the chosen state
    against the reference's over ``traffic["check_states"]`` states drawn
    with ``gen`` (the last one always among them); over every superstep
    of the window ``stay_share``, and ``select_z`` of the chosen slots
    against the selection law of the weights each superstep computed."""
    states, logp = out["draws"][0], out["logp"][0]
    T = states.shape[0]
    m = min(traffic["check_states"], T)
    idx = torch.randperm(T - 1, generator=gen, device=gen.device)[:m - 1]
    idx = torch.cat([idx, torch.tensor([T - 1], device=gen.device)])
    idx = idx.to(states.device)
    want = ref.log_density(states[idx], inp["X"], inp["Y"], config)
    return {"logp_gap": checks.logp_gap(logp[idx], want),
            "stay_share": checks.stay_share(states, out["first"]),
            "select_z": checks.select_z(out["log_accept"][0],
                                        out["root_index"][0],
                                        config["sampler"]["stabilizer"])}
