"""The generic PMP superstep as a compiled chain that records little:
``compile_chain(superstep, generator, theta0, collect)`` replayed
``steps_per_launch`` supersteps a call of ``run``, each call from the state
the last one left, for a state too large to keep every superstep's (at
d = 772 M a state is 3.09 GB).  The first call captures the CUDA graphs
(set-up).

Every superstep keeps, on the card, its log-density ``root_logp``, the
further outputs the model's check names in ``COLLECT`` (say, the
proposals' weights and the chosen slot), and ``watch`` coordinates of its
state, a fixed set drawn from ``watch_seed`` (``stay_share`` reads them).
Full states are kept for ``check_states`` launches: the window's first
``check_states - 1`` and its last.  Each is the state a call of ``run``
returns (a new tensor every call), so keeping one costs no copy, only its
memory on the card while the window runs.  ``outputs`` gives them as
``states`` with their log-densities as ``state_logp``.
"""

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
        picker = torch.Generator(device=theta0.device)
        picker.manual_seed(traffic["watch_seed"])
        watch = torch.randint(0, theta0.shape[-1], (traffic["watch"],),
                              generator=picker, device=theta0.device)
        self.watch = watch = watch.sort().values

        def collect(state, out):
            return (state.index_select(-1, watch), out["root_logp"],
                    tuple(out[k] for k in extra))

        self.K = traffic["steps_per_launch"]
        self.full = traffic["check_states"] - 1
        self.gen = gen
        self.theta = theta0
        self.chain = compile_chain(superstep, gen, theta0, collect)
        self.keep, self.records, self.kept = False, [], []
        with torch.no_grad():
            for _ in range(1 + traffic["burn_in_launches"]):
                self.launch()
        self.first = self.theta.index_select(-1, watch)
        self.keep = True

    def launch(self) -> int:
        with torch.no_grad():
            self.theta, rec = self.chain.run(self.gen, self.theta, self.K)
        if self.keep:
            self.records.append(rec)
            if len(self.kept) < self.full:
                self.kept.append((self.theta, rec[1][-1]))
        return self.K

    def outputs(self) -> dict:
        watched, logp, extra = zip(*self.records)
        kept = list(self.kept)
        if not kept or kept[-1][0] is not self.theta:
            kept.append((self.theta, logp[-1][-1]))
        out = {"draws": torch.cat(watched)[None],
               "logp": torch.cat(logp)[None], "first": self.first,
               "states": [s for s, _ in kept],
               "state_logp": torch.stack([lp for _, lp in kept])}
        for i, key in enumerate(self.extra):
            out[key] = torch.cat([e[i] for e in extra])[None]
        return out
