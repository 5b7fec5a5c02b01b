"""Declarative experiment configuration (port of ``pmpx/config.py``).

``SamplerSpec`` names the algorithm and its knobs and builds the superstep
over a target, for every sampler of the port (MH, MP, PSP, PMP and the
SP-, MP- and PMP-HMC family).  ``RunSpec`` adds the run's step count, seed
and output directory, and :func:`load_spec` reads one from a JSON file
(YAML where PyYAML imports) with dot-key overrides.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

__all__ = ["SamplerSpec", "RunSpec", "load_spec"]


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
    mom_scale: float = 1.0  # the HMC family's momentum scale
    num_leapfrog: int = 1  # SP-HMC
    accept_scale: float = 1.0  # SP-HMC

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
        from pmpx_torch.samplers import hmc, mh, mp, pmp, psp

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
        if self.algo == "sp_hmc":
            return hmc.make_superstep(
                target,
                hmc.HMCConfig(
                    step_size=self.step_size, mom_scale=self.mom_scale,
                    accept_scale=self.accept_scale,
                    num_leapfrog=self.num_leapfrog,
                ),
            )
        if self.algo == "mp_hmc":
            return hmc.make_superstep(
                target,
                hmc.MPHMCConfig(
                    N=self.N, step_size=self.step_size,
                    mom_scale=self.mom_scale,
                ),
            )
        if self.algo == "pmp_hmc":
            return hmc.make_superstep(
                target,
                hmc.PMPHMCConfig(
                    depth=self.depth, N=self.N, step_size=self.step_size,
                    mom_scale=self.mom_scale,
                    rule=self.rule if self.rule is not None else "barker",
                    stabilizer=self.stabilizer, selection=selection,
                ),
            )
        raise ValueError(f"unknown algo {self.algo!r}")


@dataclasses.dataclass
class RunSpec:
    sampler: SamplerSpec = dataclasses.field(default_factory=SamplerSpec)
    num_steps: int = 1000
    seed: int = 0
    out_dir: str = "results"
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


def load_spec(path: Optional[str] = None,
              overrides: Optional[dict] = None) -> RunSpec:
    """A :class:`RunSpec` from a JSON file, or a YAML file where PyYAML
    imports, with dot-key overrides (``{"sampler.N": 7, "num_steps":
    500}``).  Keys that are not ``RunSpec`` fields go to ``extra``."""
    raw: Dict[str, Any] = {}
    if path:
        with open(path) as f:
            text = f.read()
        try:
            raw = json.loads(text)
        except json.JSONDecodeError:
            try:
                import yaml
            except ImportError as e:
                raise ImportError(
                    f"{path} is not JSON, and reading it as YAML needs "
                    "PyYAML, which is not installed: write the spec as "
                    "JSON"
                ) from e
            raw = yaml.safe_load(text)
    for k, v in (overrides or {}).items():
        node = raw
        parts = k.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    samp = SamplerSpec(**raw.pop("sampler", {}))
    known = {f.name for f in dataclasses.fields(RunSpec)} - {"sampler",
                                                              "extra"}
    kw = {k: raw.pop(k) for k in list(raw) if k in known}
    return RunSpec(sampler=samp, extra=raw, **kw)
