"""The port's hand-written CUDA kernels, each beside its plain PyTorch
version.

``launches`` counts, per kernel, the launches its wrapper made: a wrapper
adds one where it launches its kernel and nowhere else (the plain version
on a CPU tensor does not count).  ``fused_chain`` counts one chain with
``emit="root"`` per mode, ``*_all`` one chain with ``emit="all"``, and
``fused_chain_farm`` a launch of a farm of chains in any mode,
``fused_chain_stamped`` a launch from the stamped chain library (phase
clocks; a measurement, never the main path), ``lstm_fused`` one launch
of the LSTM forward for P parameter sets, ``pmp_tree_positions`` and
``pmp_tree_select`` one launch of each side of a binary superstep's tree
(all its chains), ``pmp_tree_positions_inplace`` a launch of the
positions written over the innovations instead (where the chains'
columns are many), ``pmp_tree_gather`` the grid-wide gather of the
emitted rows where they are too many for the select kernel's blocks,
``mamba2_ssd`` one launch of the Mamba-2 SSD scan for all the sequences
of a layer (``kernels.mamba2_ssd``).
The dict is also the ``launches`` family of
:data:`pmpx_torch.profiling.counters`.
"""

launches = {
    "linreg_rss": 0,
    "fused_chain": 0,
    "fused_chain_mp": 0,
    "fused_chain_general": 0,
    "fused_chain_all": 0,
    "fused_chain_mp_all": 0,
    "fused_chain_general_all": 0,
    "fused_chain_farm": 0,
    "fused_chain_stamped": 0,
    "lstm_fused": 0,
    "pmp_tree_positions": 0,
    "pmp_tree_positions_inplace": 0,
    "pmp_tree_select": 0,
    "pmp_tree_gather": 0,
    "mamba2_ssd": 0,
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
