"""Declarative sampler configuration (port of ``SamplerSpec`` from
``pmpx/config.py``).

One dataclass names the algorithm and its knobs and builds the superstep
over a target.  ``RunSpec`` and the YAML/JSON loader are not ported yet
(ROADMAP §1 item 18), nor are the HMC samplers (item 15): ``build`` raises
``NotImplementedError`` for them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["SamplerSpec"]

_HMC_ALGOS = ("sp_hmc", "mp_hmc", "pmp_hmc")


@dataclasses.dataclass
class SamplerSpec:
    """Which sampler and its knobs.

    algo: mh | mp | psp | pmp | sp_hmc | mp_hmc | pmp_hmc
    """

    algo: str = "pmp"
    N: int = 1
    depth: int = 3
    step_size: float = 0.1
    trans_sigma: float = 1.0
    # None means "this algo's own default": all_uniform for the tree
    # samplers but single for pmp_hmc, metropolis for MH but barker for
    # pmp_hmc.  Explicit values are always honored (and rejected loudly
    # when invalid for the algo).
    selection: Optional[str] = None
    stabilizer: str = "none"
    rule: Optional[str] = None  # HMC acceptance rule / MH rule
    proposal: str = "normal"  # MH only: "uniform" for the reference SP
    # pmpx's HMC knobs (mom_scale, num_leapfrog, accept_scale) come with
    # the HMC samplers (ROADMAP §1 item 15)

    @classmethod
    def reference_nn(cls, algo: str, N: int, **kw) -> "SamplerSpec":
        """Spec for the reference's NN protocols, where ``N`` means N+1
        speculative states in a binary prefetch tree: tree samplers get
        ``N=1, depth=log2(N+1)``, flat samplers keep ``N`` at depth 1."""
        from pmpx_torch import tree

        if algo in ("pmp", "pmp_hmc", "psp"):
            return cls(algo=algo, N=1, depth=tree.binary_depth(N + 1), **kw)
        return cls(algo=algo, N=N, depth=1, **kw)

    def build(self, target):
        """Return the superstep for this spec over ``target``."""
        from pmpx_torch.samplers import mh, mp, pmp, psp

        selection = self.selection
        if selection is None:
            selection = "single" if self.algo == "pmp_hmc" else "all_uniform"
        if self.rule is not None and self.algo not in ("mh", "pmp_hmc"):
            raise ValueError(
                f"rule is not configurable for algo {self.algo!r} "
                "(mh: metropolis|barker; pmp_hmc: barker|mh_clamp|"
                "barker_clamp)"
            )

        if self.algo == "mh":
            rule = self.rule if self.rule is not None else "metropolis"
            if rule not in ("metropolis", "barker"):
                raise ValueError(
                    f"rule {rule!r} is not valid for MH "
                    "(expected 'metropolis' or 'barker')"
                )
            return mh.make_superstep(
                target,
                mh.MHConfig(step_size=self.step_size, rule=rule,
                            proposal=self.proposal),
            )
        if self.algo == "psp":
            return psp.make_superstep(
                target,
                psp.PSPConfig(
                    P=2**self.depth, step_size=self.step_size,
                    trans_sigma=self.trans_sigma, selection=selection,
                    stabilizer=self.stabilizer,
                ),
            )
        if self.algo == "mp":
            return mp.make_superstep(
                target,
                mp.MPConfig(
                    N=self.N, step_size=self.step_size,
                    trans_sigma=self.trans_sigma, selection=selection,
                    stabilizer=self.stabilizer,
                ),
            )
        if self.algo == "pmp":
            return pmp.make_superstep(
                target,
                pmp.PMPConfig(
                    N=self.N, depth=self.depth, step_size=self.step_size,
                    trans_sigma=self.trans_sigma, selection=selection,
                    stabilizer=self.stabilizer,
                ),
            )
        if self.algo in _HMC_ALGOS:
            raise NotImplementedError(
                f"algo {self.algo!r}: the HMC samplers are not ported yet "
                "(ROADMAP §1 item 15)"
            )
        raise ValueError(f"unknown algo {self.algo!r}")
