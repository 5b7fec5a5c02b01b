"""PSP — prefetching single-proposal MCMC on a binary speculation tree
(port of ``pmpx/samplers/psp.py``).

PSP is the N=1 case of the PMP engine, parameterised as the reference
parameterises it: by the number of speculative states ``P`` (a power of
two).
"""

from __future__ import annotations

import dataclasses

from pmpx_torch import tree as tree_mod
from pmpx_torch.samplers import pmp as pmp_mod
from pmpx_torch.samplers.base import Target

__all__ = ["PSPConfig", "make_superstep"]


@dataclasses.dataclass(frozen=True)
class PSPConfig:
    P: int  # speculative states; must be a power of two
    step_size: float
    trans_sigma: float = 1.0
    selection: str = "all_uniform"
    stabilizer: str = "none"
    nan_guard: bool = True

    def as_pmp(self) -> pmp_mod.PMPConfig:
        return pmp_mod.PMPConfig(
            N=1,
            depth=tree_mod.binary_depth(self.P),
            step_size=self.step_size,
            trans_sigma=self.trans_sigma,
            selection=self.selection,
            stabilizer=self.stabilizer,
            nan_guard=self.nan_guard,
        )


def make_superstep(target: Target, cfg: PSPConfig):
    """The PMP superstep of ``cfg.as_pmp()``; takes the same injected
    ``eps``, ``u`` and ``pick``."""
    return pmp_mod.make_superstep(target, cfg.as_pmp())
