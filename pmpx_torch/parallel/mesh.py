"""The device mesh of chain, data and tree parallelism, and its collectives
(port of ``pmpx/parallel/mesh.py``).

``pmpx`` names the axes of a ``jax.sharding.Mesh`` over the devices of one
program.  Here a rank is a process, and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the process group with
the same three dims:

* ``chains`` — independent chains, each rank a contiguous block of them;
* ``data`` — the likelihood's data: each rank a shard of the points, one
  ``all_reduce`` of the partial sums (:mod:`pmpx_torch.parallel.
  sharded_linreg`);
* ``tree`` — the speculative states: each rank a block of the P nodes,
  one all-gather of their log-densities (:mod:`pmpx_torch.parallel.
  tree_shard`).

A world of several ranks comes from the caller: ``torchrun`` (``env://``)
or ``init_process_group`` with a ``file://`` or ``tcp://`` address.  In a
process that has none, :func:`make_mesh` starts a world of one rank, so
that one process needs no launcher, as ``pmpx`` needs none for one device.

Every collective of the port goes through :func:`all_reduce_sum` and
:func:`all_gather_cat`, outside any ``torch.func`` transform, or through
:func:`psum`, the one that may sit inside ``vmap`` and ``grad`` (sync-BN
in a forward pass).  NCCL takes the card's tensors as they are.  A
world on gloo (several ranks that share one card, where NCCL refuses two
ranks on one GPU) gets each CUDA tensor copied to the host and back:
transport only, the computation stays on the card.  ``routes`` counts the
calls of each collective by route.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from pmpx_torch._device import resolve_device

__all__ = ["make_mesh", "AXIS_CHAINS", "AXIS_DATA", "AXIS_TREE",
           "all_reduce_sum", "all_gather_cat", "psum", "routes"]

AXIS_CHAINS = "chains"
AXIS_DATA = "data"
AXIS_TREE = "tree"

# calls of each collective by route: "direct" (the tensor as it is) or
# "host" (a CUDA tensor copied through the host for a gloo group)
routes = {"all_reduce": {"direct": 0, "host": 0},
          "all_gather": {"direct": 0, "host": 0}}


def make_mesh(
    chains: int = 1,
    data: int = 1,
    tree: int = 1,
    devices=None,
) -> Optional[DeviceMesh]:
    """A (chains, data, tree) ``DeviceMesh`` over the first
    ``chains*data*tree`` ranks of the world.

    Every rank of the world calls it (creating the mesh's process groups
    is collective over the world).  A rank past the first
    ``chains*data*tree`` has no place in the mesh, as ``pmpx`` leaves the
    devices past the first ``need`` out of its mesh: it gets ``None`` and
    runs none of the mesh's work.

    Without a process group, a world of one rank is started: NCCL on
    ``devices`` (the card unless the caller names the CPU, where the
    world takes gloo; it raises without a card, as every entry point
    does).  Otherwise ``devices`` is not read: the mesh's device type
    follows the world's backend (``cuda`` for NCCL, ``cpu`` for gloo, whose
    ranks may still compute on the card).  Raises ``pmpx``'s ValueError
    when the world has fewer ranks than the mesh.
    """
    need = chains * data * tree
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < need:
        raise ValueError(
            f"need {need} devices for mesh ({chains},{data},{tree}), "
            f"have {have}"
        )
    if not dist.is_initialized():
        dev = resolve_device(devices)
        if dev.type == "cuda":  # NCCL's device, before the world
            torch.cuda.set_device(torch.cuda.current_device()
                                  if dev.index is None else dev.index)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = DeviceMesh(kind, torch.arange(need).reshape(chains, data, tree),
                      mesh_dim_names=(AXIS_CHAINS, AXIS_DATA, AXIS_TREE))
    return mesh if mesh.get_coordinate() is not None else None


def _via_host(t: torch.Tensor, group) -> bool:
    return t.device.type != "cpu" and dist.get_backend(group) != "nccl"


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum of ``t`` over the ranks of ``group``, as a new
    tensor on ``t``'s device (``t`` is left as it is)."""
    host = _via_host(t, group)
    buf = t.detach().cpu().contiguous() if host else t.detach().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    routes["all_reduce"]["host" if host else "direct"] += 1
    return buf.to(t.device) if host else buf


class _Psum(torch.autograd.Function):
    """:func:`all_reduce_sum` as a function that autograd and
    ``torch.func`` can transform.  Its adjoint is itself: the cotangent of
    a sum over the group is the sum over the group of the ranks'
    cotangents (``lax.psum``'s transpose).  Its ``vmap`` rule reduces the
    whole batch in one collective, where vmap's fallback would make one
    per sample and return the wrong sums."""

    @staticmethod
    def forward(x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Psum.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        if in_dims[0] is None:
            return _Psum.apply(x, group), None
        return _Psum.apply(x.movedim(in_dims[0], 0), group), 0


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum of ``x`` over the ranks of ``group``, on
    ``x``'s device, differentiable (its gradient is the group's sum of
    the ranks' cotangents) and batched under ``torch.func.vmap`` (one
    collective for the whole batch: a ``vmap`` with ``chunk_size`` makes
    one per chunk).  Every rank of the group must call it in the same
    order with tensors of the same shape, as every collective must."""
    if isinstance(group, str):
        raise TypeError(
            f"psum over {group!r}: pass the axis's process group "
            f"(mesh.get_group({group!r})); no axis name is in scope here")
    return _Psum.apply(x, group)


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` of ``group`` concatenated along ``dim`` in rank
    order, on ``t``'s device.  Every rank's ``t`` has the same shape."""
    host = _via_host(t, group)
    src = (t.detach().cpu() if host else t.detach()).contiguous()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    routes["all_gather"]["host" if host else "direct"] += 1
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if host else out
