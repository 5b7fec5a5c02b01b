"""Chain, data and tree parallelism (port of ``pmpx/parallel``): the
device mesh and its collectives (:mod:`~pmpx_torch.parallel.mesh`),
several chains on one card or over the mesh's ``chains`` axis, with the
fused chain farm (:mod:`~pmpx_torch.parallel.chains`), the linreg
likelihood over the ``data`` axis (:mod:`~pmpx_torch.parallel.
sharded_linreg`), the NN posteriors over the ``data`` axis with sync-BN
(:mod:`~pmpx_torch.parallel.sharded_nn`) and the PMP superstep over the
``tree`` axis (:mod:`~pmpx_torch.parallel.tree_shard`)."""

from pmpx_torch.parallel.mesh import (
    AXIS_CHAINS,
    AXIS_DATA,
    AXIS_TREE,
    make_mesh,
)
from pmpx_torch.parallel.chains import (
    chain_generators,
    make_chain_farm_fused,
    run_chains_data_sharded,
    run_chains_fused,
    run_chains_sharded,
    run_chains_vmapped,
)
from pmpx_torch.parallel.sharded_linreg import ShardedLinReg
from pmpx_torch.parallel.sharded_nn import ShardedNNPosterior
from pmpx_torch.parallel.tree_shard import make_tree_sharded_superstep

__all__ = [
    "AXIS_CHAINS",
    "AXIS_DATA",
    "AXIS_TREE",
    "make_mesh",
    "chain_generators",
    "run_chains_data_sharded",
    "make_chain_farm_fused",
    "run_chains_fused",
    "run_chains_sharded",
    "run_chains_vmapped",
    "ShardedLinReg",
    "ShardedNNPosterior",
    "make_tree_sharded_superstep",
]
