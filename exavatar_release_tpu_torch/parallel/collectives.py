"""Differentiable collectives over a ``torch.distributed`` process group:
what ``shard_map`` and XLA insert for the JAX package's in-context code.

- ``all_gather``: tiled over dim 0; its backward is a reduce-scatter with
  SUM, which routes each rank's slice of the cotangent, summed over every
  rank that used it, back to the slice's owner (JAX's transpose of a tiled
  ``all_gather``);
- ``all_to_all``: D equal buckets along dim 0, bucket d to rank d; its
  backward is the same exchange of the cotangents (the operation is its
  own transpose);
- ``psum`` / ``pmax``: counters and statistics, with no gradient.

Ranks are numbered as the group numbers them; for a ``ProcessMesh`` axis
that is the index along the axis.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        g = g.contiguous()
        out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
        # reduce_scatter_single is the newer name of reduce_scatter_tensor
        rs = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
        rs(out, g, op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """(n, ...) on each of D ranks -> (D*n, ...), rank-major, on every rank."""
    return _AllGather.apply(x, group)


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """(D*c, ...) send buffer, rows [d*c, (d+1)*c) for rank d -> (D*c, ...)
    received, rows [s*c, (s+1)*c) from rank s."""
    return _AllToAll.apply(x, group)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the group's ranks, outside autograd."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """Largest value over the group's ranks, outside autograd."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out
