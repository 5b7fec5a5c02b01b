"""The Bayesian linreg likelihood over a sharded data axis: a sweep of the
rank's shard, then one ``all_reduce`` (port of
``pmpx/parallel/sharded_linreg.py``).

Each rank holds a shard of (x, y) and computes the local RSS of all P
proposals with the single-card sweep (``linreg_rss`` on the card, its
plain version on the CPU); one ``all_reduce(SUM)`` of the (P,) local RSS
over the data axis's process group gives the global RSS, and the Gaussian
normalisation takes the global count.  ``pmpx`` builds its target inside
``shard_map`` and psums over an axis name; here the target is built on
each rank from its shard (see :func:`pmpx_torch.parallel.
run_chains_data_sharded`) and reduces over the group of that axis.
"""

from __future__ import annotations

from pmpx_torch.parallel.mesh import AXIS_DATA, all_reduce_sum
from pmpx_torch.targets.linreg import BayesLinReg, loglik_from_rss

__all__ = ["ShardedLinReg"]


class ShardedLinReg:
    """One rank's shard of a ``BayesLinReg`` target; the global
    log-likelihood through one ``all_reduce`` over the data axis.

    ``n_total`` is the global point count (the normalisation); the sum
    runs over ``mesh``'s group of ``axis``.  ``method``: the sweep
    (``pmpx``'s ``"xla"`` and ``"pallas"`` are its names, as for
    ``BayesLinReg``).  The sweep reads the shard's real points only, so
    ``pmpx``'s ``pad_count * b0**2`` correction for the zero padding has
    no counterpart here.  The shard stays on the device of ``x_local``
    where it is a tensor, else goes to the card.  The collective runs in
    plain calls, never inside a ``torch.func`` transform.
    """

    d = 3
    # run_chain keeps its supersteps eager: the sum is a collective (on
    # gloo a copy through the host), which no CUDA graph of one rank holds
    eager_only = "its density all-reduces over the data axis"

    def __init__(self, x_local, y_local, n_total: int, temper: float = 1.0,
                 axis: str = AXIS_DATA, method: str = "sweep", *, mesh):
        if method in ("pallas", "xla"):
            method = "sweep"
        if method != "sweep":
            raise ValueError(f"ShardedLinReg sweeps its shard; unknown "
                             f"method {method!r}")
        self.group = mesh.get_group(axis)
        self.local = BayesLinReg(x_local, y_local, temper=temper,
                                 method=method,
                                 device=getattr(x_local, "device", None))
        self.axis = axis
        self.method = method
        self.temper = float(temper)
        self.n_total = int(n_total)

    def log_prob(self, theta):
        return self.log_prob_batch(theta[None, :])[0]

    def log_prob_batch(self, Theta):
        local = self.local._rss_padded(Theta[:, 0], Theta[:, 1])
        rss = all_reduce_sum(local, self.group)
        return loglik_from_rss(rss, Theta[:, 2], self.n_total, self.temper)
