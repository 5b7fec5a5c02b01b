from pmpx_torch.samplers.base import Target, Tempered, batch_log_prob, run_chain
from pmpx_torch.samplers.mh import MHConfig
from pmpx_torch.samplers.mp import MPConfig
from pmpx_torch.samplers.pmp import PMPConfig
from pmpx_torch.samplers.psp import PSPConfig

__all__ = [
    "Target",
    "Tempered",
    "batch_log_prob",
    "run_chain",
    "MHConfig",
    "MPConfig",
    "PMPConfig",
    "PSPConfig",
]
