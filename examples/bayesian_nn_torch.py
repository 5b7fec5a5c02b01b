"""Bayesian NN posterior sampling with a PMP-HMC speculation tree (the
port of ``examples/bayesian_nn.py``, in PyTorch).

Run: python examples/bayesian_nn_torch.py            # on the CUDA card
     python examples/bayesian_nn_torch.py --device cpu
(Uses the synthetic MNIST stand-in when no dataset is on disk.)
"""

import argparse
import sys
from pathlib import Path

import torch

try:
    import pmpx_torch  # installed
except ModuleNotFoundError:  # running from a source checkout
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import pmpx_torch
from pmpx_torch._device import resolve_device
from pmpx_torch.data import load_mnist
from pmpx_torch.models import BayesMLP
from pmpx_torch.samplers import hmc
from pmpx_torch.targets.nn import NNPosterior


def _generator(dev, seed: int) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def main(num_steps: int = 100, device=None) -> dict:
    """Runs the chain and prints its first and last loss and the test
    accuracy; returns them."""
    dev = resolve_device(device)
    x_tr, y_tr, x_te, y_te = load_mnist(n_train=4096, n_test=1024,
                                        device=dev)

    posterior = NNPosterior(
        BayesMLP(hidden=64),
        x_tr,
        y_tr,
        seed=0,
        stochastic=True,  # torchbnn-style sampling forward
        device=dev,
    )

    cfg = pmpx_torch.PMPHMCConfig(
        depth=3,  # 8 speculative states per superstep
        step_size=0.1,
        mom_scale=0.0005,
        rule="barker_clamp",
    )
    superstep = hmc.make_superstep(posterior, cfg)

    # the loss and the accuracy each evaluate on one fixed draw of the
    # weight noise, drawn here once: the chain on the card replays a
    # captured graph, which replays only the draws of the chain's own
    # generator
    loss_noise = posterior.draw_noise(_generator(dev, 9))
    acc_noise = posterior.draw_noise(_generator(dev, 7))

    def loss(th, o):
        return -posterior.log_prob(th, noise=loss_noise)

    theta0 = posterior.init_theta()
    with torch.no_grad():
        thetaF, losses = pmpx_torch.run_chain(
            superstep, _generator(dev, 1), theta0, num_steps, collect=loss)
        acc = posterior.accuracy(thetaF, x_te, y_te, noise=acc_noise)
    out = {"loss_first": float(losses[0]), "loss_last": float(losses[-1]),
           "test_accuracy": float(acc)}
    print(f"loss: {out['loss_first']:.3f} -> {out['loss_last']:.3f}")
    print(f"test accuracy: {out['test_accuracy']:.3f}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    main(device=ap.parse_args().device)
