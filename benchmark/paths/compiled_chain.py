"""The generic PMP superstep as a compiled chain: ``compile_chain(superstep,
generator, theta0, collect)`` replayed ``steps_per_launch`` supersteps a
call of ``run``, each call from the state the last one left.  The first
call captures the CUDA graphs (set-up); each superstep's state and the
log-density the superstep computed for it are kept on the card, with the
superstep's further outputs that the model's check names in ``COLLECT``
(say, the proposals' weights and the chosen slot)."""

from __future__ import annotations

import torch

__all__ = ["Run"]


class Run:
    def __init__(self, model, config: dict, traffic: dict, inp: dict,
                 gen: torch.Generator, device):
        from pmpx_torch.samplers.base import compile_chain

        superstep, theta0 = model.program_chain(config, inp, device)
        self.extra = tuple(getattr(model, "COLLECT", ()))
        extra = self.extra

        def collect(state, out):
            return state, out["root_logp"], tuple(out[k] for k in extra)

        self.K = traffic["steps_per_launch"]
        self.gen = gen
        self.theta = theta0
        self.chain = compile_chain(superstep, gen, theta0, collect)
        self.keep, self.records = False, []
        with torch.no_grad():
            for _ in range(1 + traffic["burn_in_launches"]):
                self.launch()
        self.first = self.theta.clone()
        self.keep = True

    def launch(self) -> int:
        with torch.no_grad():
            self.theta, rec = self.chain.run(self.gen, self.theta, self.K)
        if self.keep:
            self.records.append(rec)
        return self.K

    def outputs(self) -> dict:
        states, logp, extra = zip(*self.records)
        out = {"draws": torch.cat(states)[None],
               "logp": torch.cat(logp)[None], "first": self.first}
        for i, key in enumerate(self.extra):
            out[key] = torch.cat([e[i] for e in extra])[None]
        return out
