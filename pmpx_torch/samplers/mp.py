"""MP — flat generalized multiple-try Metropolis (port of
``pmpx/samplers/mp.py``).

Structurally MP is a depth-1 proposal tree: one sibling group of N+1
states (current + N proposals), weights ``A_j = pi(y_j) * prod_{k != j}
K(y_j, y_k)``, categorical resampling.  This module is a thin wrapper over
:mod:`pmpx_torch.samplers.pmp`.
"""

from __future__ import annotations

import dataclasses

from pmpx_torch.samplers import pmp as pmp_mod
from pmpx_torch.samplers.base import Target

__all__ = ["MPConfig", "make_superstep"]


@dataclasses.dataclass(frozen=True)
class MPConfig:
    N: int
    step_size: float
    trans_sigma: float = 1.0
    trans_normalize_by: float = 1.0
    selection: str = "all_uniform"
    stabilizer: str = "none"
    nan_guard: bool = True

    def as_pmp(self) -> pmp_mod.PMPConfig:
        return pmp_mod.PMPConfig(
            N=self.N,
            depth=1,
            step_size=self.step_size,
            trans_sigma=self.trans_sigma,
            trans_normalize_by=self.trans_normalize_by,
            selection=self.selection,
            stabilizer=self.stabilizer,
            nan_guard=self.nan_guard,
        )


def make_superstep(target: Target, cfg: MPConfig):
    """The PMP superstep of ``cfg.as_pmp()``; takes the same injected
    ``eps``, ``u`` and ``pick``."""
    return pmp_mod.make_superstep(target, cfg.as_pmp())
