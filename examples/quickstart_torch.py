"""Quickstart: sample a banana distribution with PMP and diagnose it
(the port of ``examples/quickstart.py``, in PyTorch).

Run: python examples/quickstart_torch.py            # on the CUDA card
     python examples/quickstart_torch.py --device cpu
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
from pmpx_torch.metrics import ess_per_dim, msjd
from pmpx_torch.samplers import pmp
from pmpx_torch.targets import Banana


def main(num_steps: int = 10_000, device=None) -> dict:
    """Runs the chain and prints its diagnostics; returns the records'
    shape, the kept samples (a NumPy array) and the printed values."""
    dev = resolve_device(device)
    # 16 speculative states per superstep: 3 proposals/node, 2 levels deep
    cfg = pmpx_torch.PMPConfig(N=3, depth=2, step_size=0.7)
    superstep = pmp.make_superstep(Banana(), cfg)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    with torch.no_grad():
        theta, recs = pmpx_torch.run_chain(
            superstep, gen, torch.tensor([0.0, -8.0], device=dev), num_steps)

    # every superstep emits its 16 states; the first 2000 supersteps'
    # 32,000 are burn-in
    samples = recs["samples"].reshape(-1, 2)[32_000:]
    ess = ess_per_dim(samples)
    jump = float(msjd(samples))
    mean = samples.mean(dim=0)
    print(f"samples: {tuple(samples.shape)}")
    print(f"E[x1] = {float(mean[0]):+.3f}   (analytic 0)")
    print(f"E[x2] = {float(mean[1]):+.3f}   (analytic -8)")
    print(f"ESS per dim: {ess.cpu().numpy()}")
    print(f"MSJD: {jump:.4f}")
    return {"records_shape": tuple(recs["samples"].shape),
            "samples": samples.cpu().numpy(),
            "mean": mean.cpu().numpy(), "ess": ess.cpu().numpy(),
            "msjd": jump}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    main(device=ap.parse_args().device)
