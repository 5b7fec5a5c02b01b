"""Operations and bytes of the linreg configuration's work, counted from its
shapes as the algorithm needs them (not as a kernel happens to compute
them).  P = 2**depth positions of d = 3 over n points.

A superstep, beside the likelihood (O(P) terms, flops a position):
innovations d (the step's scale); positions d * depth / 2 (a binary node
sums the innovations of its set bits, depth / 2 on average); the
log-density from the residual sum 6; the Barker walk 5 a level; the
selection 5 (softmax 3, cumulative sum 1, compare 1).

The likelihood:
* ``sweep``: every point at every position, 5 flops (residual 3, square
  1, sum 1); x and y read once a superstep;
* ``fused``: the residual sum from the five data sums, 14 flops a
  position; the sums themselves, 8 flops a point, once a launch of
  ``chunk`` supersteps, which reads x and y once and writes 4 floats a
  superstep and chain.
"""

from __future__ import annotations

__all__ = ["superstep", "rss_call", "chain_launch"]

_F32 = 4
_D = 3


def _tree_flops(config: dict) -> float:
    depth = config["sampler"]["depth"]
    P = 2 ** depth
    return P * (_D + _D * depth / 2 + 6 + 5 * depth + 5)


def rss_call(config: dict) -> tuple:
    """(flops, bytes) of one likelihood call over every point."""
    P, n = 2 ** config["sampler"]["depth"], config["n_data"]
    return 5.0 * P * n, _F32 * (2 * n + 3 * P)


def chain_launch(config: dict, chunk: int, chains: int = 1) -> tuple:
    """(flops, bytes) of one fused launch of ``chunk`` supersteps of
    ``chains`` chains."""
    P, n = 2 ** config["sampler"]["depth"], config["n_data"]
    flops = chains * chunk * (_tree_flops(config) + 14.0 * P) + 8.0 * n
    return flops, _F32 * (2 * n + chains * (4 * chunk + 6))


def superstep(config: dict, traffic: dict) -> tuple:
    """(flops, bytes) of one superstep of one chain on the cell's path."""
    if traffic["path"] == "compiled_chain":
        f, b = rss_call(config)
        return f + _tree_flops(config), b
    chunk = traffic["chunk"]
    f, b = chain_launch(config, chunk, traffic.get("chains", 1))
    c = traffic.get("chains", 1)
    return f / (chunk * c), b / (chunk * c)
