"""The collectives of tensor, expert and sequence parallelism as autograd
functions (no counterpart in ``image2text_tpu/parallel/``: GSPMD inserts
them in the JAX package; here they are written out).

An :class:`Axis` is one axis of the mesh as this rank sees it: its
process group, its size and this rank's index along it.  A size-1 axis
makes every function here the identity.

* :func:`copy_to` and :func:`reduce_from` are Megatron's ``f`` and ``g``:
  the entry of a column-parallel region (forward the identity, backward
  the sum of the ranks' partial gradients) and the exit of a row-parallel
  one (forward the sum of the ranks' partial products, backward the
  identity).
* :func:`scatter_to` keeps this rank's chunk of a dimension, or of each
  of its ``sections`` equal sections (backward: the chunks' gradients
  gathered back), :func:`gather_from` joins the
  ranks' chunks (backward: this rank's chunk of a gradient that is the
  same on every rank).  Sequence parallelism uses them on the sequence
  axis at the blocks' boundaries, the expert-parallel MoE on the expert
  axis of the combine weights, a row-parallel Linear on a replicated
  input (an int4 one takes its chunk of each half of its input: the
  pairs of its packed bytes, ``sharding_rules`` module docstring).
* :func:`gather_data` joins the data ranks' rows with the backward of a
  sum over ranks (a reduce-scatter): the contrastive loss scores every
  rank's rows against the global batch.

Every collective is issued with ``async_op=False`` from the caller's
stream: it is ordered after what the stream queued before it, and what
follows waits for it.  On a CPU tensor the group is a gloo group.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
import torch.distributed as dist


class Axis(NamedTuple):
    """One mesh axis seen from this rank."""

    group: Optional[object]   # a ProcessGroup; None for a size-1 axis
    size: int
    rank: int


LOCAL = Axis(None, 1, 0)


def _all_reduce(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, group=axis.group)
    return t


def _all_gather(t: torch.Tensor, axis: Axis, dim: int,
                sections: int = 1) -> torch.Tensor:
    """The ranks' shards joined: of each of ``sections`` sections, every
    rank's chunk in rank order (the inverse of :func:`shard_of`)."""
    t = t.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t, group=axis.group)
    if sections == 1:
        return torch.cat(parts, dim=dim)
    per = [p.chunk(sections, dim=dim) for p in parts]
    return torch.cat([per[r][s] for s in range(sections)
                      for r in range(axis.size)], dim=dim)


def chunk_of(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This rank's chunk of ``t`` along ``dim`` (which ``axis.size``
    divides)."""
    n = t.shape[dim]
    if n % axis.size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide "
                         f"over {axis.size} ranks")
    c = n // axis.size
    return t.narrow(dim, axis.rank * c, c).contiguous()


def shard_of(t: torch.Tensor, axis: Axis, dim: int,
             sections: int = 1) -> torch.Tensor:
    """This rank's shard of ``t`` along ``dim``: of each of ``sections``
    equal sections, its chunk, concatenated."""
    if sections == 1:
        return chunk_of(t, axis, dim)
    return torch.cat([chunk_of(s, axis, dim)
                      for s in t.chunk(sections, dim=dim)], dim=dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, sections):
        ctx.axis, ctx.dim, ctx.sections = axis, dim, sections
        return shard_of(x, axis, dim, sections)

    @staticmethod
    def backward(ctx, g):
        return (_all_gather(g, ctx.axis, ctx.dim, ctx.sections), None, None,
                None)


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return chunk_of(g, ctx.axis, ctx.dim), None, None


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_gather(x, axis, 0)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = g.new_empty((g.shape[0] // ctx.axis.size, *g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, group=ctx.axis.group)
        return out, None


def copy_to(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _ReduceFrom.apply(x, axis)


def scatter_to(x: torch.Tensor, axis: Axis, dim: int,
               sections: int = 1) -> torch.Tensor:
    return x if axis.size == 1 else _ScatterTo.apply(x, axis, dim, sections)


def gather_from(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    return x if axis.size == 1 else _GatherFrom.apply(x, axis, dim)


def gather_data(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _GatherData.apply(x, axis)


@torch.no_grad()
def gather_whole(t: torch.Tensor, axis: Axis, dim: int,
                 sections: int = 1) -> torch.Tensor:
    """The whole tensor of which each rank of ``axis`` holds a shard along
    ``dim`` (``sections`` packed sections, each split on its own: see
    ``sharding_rules.shard``); no gradient."""
    if axis.size == 1:
        return t
    return _all_gather(t, axis, dim, sections)


__all__ = ["Axis", "LOCAL", "chunk_of", "copy_to", "gather_data",
           "gather_from", "gather_whole", "reduce_from", "scatter_to",
           "shard_of"]
