"""The port's hand-written CUDA kernels, each beside its plain PyTorch
version.

``launches`` counts, per kernel, the launches its wrapper made: a wrapper
adds one where it launches its kernel and nowhere else (the plain version
on a CPU tensor does not count).
"""

launches = {
    "linreg_rss": 0,
    "fused_chain": 0,
    "fused_chain_mp": 0,
    "fused_chain_general": 0,
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
