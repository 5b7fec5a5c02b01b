"""Several chains at once (port of ``pmpx/parallel``; so far its
one-device parts: the chain-batched superstep and the fused chain farm of
:mod:`pmpx_torch.parallel.chains`)."""

from pmpx_torch.parallel.chains import (
    chain_generators,
    make_chain_farm_fused,
    run_chains_fused,
    run_chains_vmapped,
)

__all__ = ["chain_generators", "make_chain_farm_fused", "run_chains_fused",
           "run_chains_vmapped"]
