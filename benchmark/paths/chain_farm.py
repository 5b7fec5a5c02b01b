"""A farm of C chains in one launch of the fused megakernel, a block a
chain: ``make_chain_farm_fused(target, cfg, chunk, chunk=chunk,
rng="kernel")`` launched a chunk after another.  Each chunk's roots are
consumed and dropped; every ``thin``-th superstep of every chain is kept on
the card for the check (held whole, a window's roots would take GBs)."""

from __future__ import annotations

import torch

__all__ = ["Run"]


class Run:
    def __init__(self, model, config: dict, traffic: dict, inp: dict,
                 gen: torch.Generator, device):
        from pmpx_torch.parallel.chains import make_chain_farm_fused

        target = model.program_target(config, inp, device)
        self.chunk, self.C = traffic["chunk"], traffic["chains"]
        self.thin = traffic["thin"]
        self.runner = make_chain_farm_fused(
            target, model.sampler_config(config), self.chunk,
            chunk=self.chunk, rng="kernel")
        seeds = torch.randint(0, 2**62, (self.C,), generator=gen,
                              device=gen.device).tolist()
        self.gens = [torch.Generator(device=device).manual_seed(s)
                     for s in seeds]
        self.theta = inp["theta0"].expand(self.C, -1).contiguous()
        self.keep, self.parts = False, []
        for _ in range(traffic["burn_in_launches"]):
            self.launch()
        self.first = self.theta.clone()
        self.keep = True

    def launch(self) -> int:
        roots = self.runner(self.gens, self.theta)
        self.theta = roots[:, -1]
        if self.keep:
            self.parts.append(roots[:, self.thin - 1::self.thin].clone())
        return self.chunk * self.C

    def outputs(self) -> dict:
        return {"draws": torch.cat(self.parts, dim=1), "first": self.first}
