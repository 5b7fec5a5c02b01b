"""One chain in the fused megakernel: ``make_fused_chain(target, cfg,
chunk, rng="kernel")`` launched a chunk of supersteps after another, each
from the state the last one left.  Every root draw of the window is kept
on the card."""

from __future__ import annotations

import torch

__all__ = ["Run"]


class Run:
    def __init__(self, model, config: dict, traffic: dict, inp: dict,
                 gen: torch.Generator, device):
        from pmpx_torch.kernels import fused_chain as fc

        target = model.program_target(config, inp, device)
        self.chunk = traffic["chunk"]
        self.runner = fc.make_fused_chain(target, model.sampler_config(config),
                                          chunk=self.chunk, rng="kernel")
        self.gen = gen
        self.theta = inp["theta0"]
        self.keep, self.parts = False, []
        for _ in range(traffic["burn_in_launches"]):
            self.launch()
        self.first = self.theta.clone()
        self.keep = True

    def launch(self) -> int:
        roots = self.runner(self.gen, self.theta, self.chunk)
        self.theta = roots[-1]
        if self.keep:
            self.parts.append(roots)
        return self.chunk

    def outputs(self) -> dict:
        return {"draws": torch.cat(self.parts)[None], "first": self.first}
