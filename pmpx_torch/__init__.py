"""pmpx_torch — prefetching multiple-proposal MCMC in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100, ``sm_90a``).

The port of ``pmpx`` (JAX), which stays beside it as the reference: each
module here keeps the name and layout of its ``pmpx`` counterpart.  This
package imports ``torch`` and never ``jax`` or ``pmpx``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
there a kernel wrapper runs its plain PyTorch version.  Importing the
package does no CUDA work: the kernels are built with ``nvcc`` at their
first launch (``pmpx_torch._build``).
"""

import torch

from pmpx_torch import tree
from pmpx_torch.transition import GaussianRW
from pmpx_torch.samplers.base import Target, Tempered, batch_log_prob, run_chain
from pmpx_torch.samplers.pmp import PMPConfig
from pmpx_torch.samplers.mp import MPConfig
from pmpx_torch.samplers.mh import MHConfig
from pmpx_torch.samplers.hmc import HMCConfig, MPHMCConfig, PMPHMCConfig
from pmpx_torch.config import RunSpec, SamplerSpec, load_spec

# Arithmetic that feeds densities runs in full f32: no TF32 in matmuls or
# convolutions (the rule of pmpx/kernels/fused_chain.py's HIGHEST-precision
# dots and pmpx/transition.py's gram).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = [
    "tree",
    "GaussianRW",
    "Target",
    "Tempered",
    "batch_log_prob",
    "run_chain",
    "PMPConfig",
    "MPConfig",
    "MHConfig",
    "HMCConfig",
    "MPHMCConfig",
    "PMPHMCConfig",
    "RunSpec",
    "SamplerSpec",
    "load_spec",
]
