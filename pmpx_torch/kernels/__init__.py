"""The port's hand-written CUDA kernels, each beside its plain PyTorch
version.

``launches`` counts, per kernel, the launches its wrapper made: a wrapper
adds one where it launches its kernel and nowhere else (the plain version
on a CPU tensor does not count).  ``fused_chain`` counts one chain with
``emit="root"`` per mode, ``*_all`` one chain with ``emit="all"``, and
``fused_chain_farm`` a launch of a farm of chains in any mode.
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
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
