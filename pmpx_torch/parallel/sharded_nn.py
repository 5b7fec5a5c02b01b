"""The NN posteriors over a sharded data axis: each rank evaluates every
proposal network on its shard of the images, then one ``all_reduce`` of
the cross-entropy sums, and one of the gradients (port of
``pmpx/parallel/sharded_nn.py``).

The reference evaluates every proposal network on all 60,000 MNIST or
50,000 CIFAR images on one GPU (``PMP_FC.py:117-118``,
``cifar_PMPhmc.py:126-163``).  Here the image batch shards over the
``data`` axis of a mesh: each rank evaluates all P networks on its local
shard (the packed layout and ``proposal_chunk`` compose unchanged), and
the sum over the axis's process group of the local cross-entropy *sums*
gives the global mean loss; for HMC a second sum gives the global
gradient of the replicated theta.

Models with BatchNorm need the *global* batch statistics, or the sharded
density is another function: the model is rebound through
``with_bn_axis`` to its sync-BN variant over the axis's process group
(:func:`pmpx_torch.models._layers.batch_norm`,
:func:`pmpx_torch.kernels.convpack.batchnorm`), whose collectives sit
inside the ``torch.func`` transforms through
:func:`pmpx_torch.parallel.mesh.psum` (one collective per BatchNorm, per
chunk of proposals, in each pass).  The reductions of the values,
gradients and counts run outside the transforms, through
:func:`~pmpx_torch.parallel.mesh.all_reduce_sum`.  Every rank must hold a
shard of the same size: sync-BN averages the ranks' statistics, as
``pmpx``'s ``pmean`` does.

``pmpx`` builds its target inside ``shard_map`` from the local shard; here
each rank builds it from its shard and the ``mesh`` (no axis name is in
scope), and every rank of the data group must make the same calls in the
same order.  A stochastic model (``BayesMLP``) draws its weight noise from
the caller's generator, which must be in the same state on every rank of
the group (seeded from the chain alone, as
:func:`pmpx_torch.parallel.run_chains_data_sharded` seeds it), so that
every shard sees the same networks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.func import grad_and_value, vmap

from pmpx_torch.parallel.mesh import AXIS_DATA, all_reduce_sum
from pmpx_torch.targets.nn import NNPosterior

__all__ = ["ShardedNNPosterior"]


class ShardedNNPosterior:
    """The target protocol over one rank's data shard; the global density
    through the data group's sum.

    The global log-density is ``-temper * sum_ranks(local CE sum) /
    n_total``, the unsharded ``NNPosterior``'s on the concatenated shards
    (the mean of the per-example CE); a one-rank mesh gives its values
    bit for bit.  The template's model (rebound to sync-BN), parameter
    layout, temper, ``compute_dtype``, ``proposal_chunk`` and stochastic
    noise are inherited.  Its fused density (``lstm_fused.attach``) is
    not: the sharded posterior runs the generic forward, as ``pmpx``'s
    does.
    """

    # run_chain keeps its supersteps eager: the sum is a collective (on
    # gloo a copy through the host), which no CUDA graph of one rank holds
    eager_only = "its density all-reduces over the data axis"

    # the template's machinery, on the same attributes
    unravel = NNPosterior.unravel
    _noise = NNPosterior._noise
    _logits = NNPosterior._logits
    _chunk = NNPosterior._chunk

    def __init__(self, template: NNPosterior, x_local, y_local,
                 n_total: int, axis: str = AXIS_DATA, *, mesh):
        self.group = mesh.get_group(axis)
        model = template.model
        if hasattr(model, "with_bn_axis"):
            model = model.with_bn_axis(self.group)
        dev = template.device
        self.device = dev
        self.model = model.to(dev)
        self.compute_dtype = template.compute_dtype
        self.temper = template.temper
        self.stochastic = template.stochastic
        self.needs_rng = template.needs_rng
        self._noise_shapes = template._noise_shapes
        self.proposal_chunk = template.proposal_chunk
        self._slices = template._slices
        self.d = template.d
        X = torch.as_tensor(x_local, dtype=torch.float32, device=dev)
        self.X = X if self.compute_dtype is None else X.to(self.compute_dtype)
        self.Y = torch.as_tensor(y_local, device=dev).long()
        self.n_total = int(n_total)
        self.axis = axis

    @classmethod
    def from_posterior(cls, template: NNPosterior, x_local, y_local,
                       n_total: int, axis: str = AXIS_DATA, *, mesh):
        return cls(template, x_local, y_local, n_total, axis, mesh=mesh)

    # -- the local shard ---------------------------------------------
    def _local_neg_loss_sum(self, theta: torch.Tensor,
                            noise=None) -> torch.Tensor:
        logits = self._logits(theta, self.X, noise)
        # the local CE sum over n_total, as the local mean times the
        # shard's share of the images: on one rank the share is 1.0 and
        # this is NNPosterior's -temper * mean bit for bit (a CUDA mean
        # multiplies by 1/n, so sum / n may differ from it in the last bit)
        share = self.Y.shape[0] / self.n_total
        return -self.temper * (F.cross_entropy(logits.float(), self.Y)
                               * share)

    def _local_batch(self, fn, Theta: torch.Tensor, generator):
        chunk = self._chunk(Theta.shape[0])
        if self.stochastic:
            noise = self._noise(generator, (Theta.shape[0],))
            return vmap(fn, chunk_size=chunk)(Theta, noise)
        return vmap(fn, chunk_size=chunk)(Theta)

    # -- the target protocol (global semantics) ----------------------
    def log_prob(self, theta: torch.Tensor, generator=None) -> torch.Tensor:
        local = self._local_neg_loss_sum(theta, self._noise(generator))
        return all_reduce_sum(local, self.group)

    def log_prob_batch(self, Theta: torch.Tensor,
                       generator=None) -> torch.Tensor:
        local = self._local_batch(self._local_neg_loss_sum, Theta, generator)
        return all_reduce_sum(local, self.group)

    def value_and_grad_batch(self, Theta: torch.Tensor, generator=None):
        grads, values = self._local_batch(
            grad_and_value(self._local_neg_loss_sum), Theta, generator)
        return (all_reduce_sum(values, self.group),
                all_reduce_sum(grads, self.group))

    def accuracy(self, theta: torch.Tensor, X=None, Y=None,
                 generator=None) -> torch.Tensor:
        """The global accuracy over the group: the sum of the ranks'
        correct counts over the sum of their example counts (one
        collective of the pair); a stochastic model draws one set of
        weights from ``generator``."""
        X = self.X if X is None else X
        Y = self.Y if Y is None else Y
        with torch.no_grad():
            logits = self._logits(theta, X, self._noise(generator))
            local = torch.stack([(logits.argmax(dim=-1) == Y).sum(),
                                 torch.tensor(Y.shape[0], device=Y.device)])
            correct, count = all_reduce_sum(local.float(), self.group)
            return correct / count
