"""Collectives that carry autograd, for the mesh steps' explicit schedule.

Each takes a plain local tensor and a :class:`launch.mesh.Group` (one
rank: the tensor itself, both ways).  The tensor-parallel pair is
Megatron's: :func:`reduce_from` sums the partial results of a split
computation (all-reduce forward, identity backward) and :func:`copy_to`
enters one (identity forward, all-reduce of the gradients backward).
:func:`gather_along` all-gathers a sharded weight before use; its
backward reduce-scatters the gradient (``"sum"``: the ranks computed on
different data or different slices) or takes this rank's slice of it
(``"slice"``: they computed the same thing).  gloo has no reduce-scatter,
so there it is an all-reduce and a slice.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

#: all-gather into one tensor (renamed ``all_gather_single`` in newer
#: PyTorch, which warns on the old name)
_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((group.size * x.shape[0],) + tuple(x.shape[1:]))
    _gather_into(out, x, group=group.pg)
    return out.movedim(0, dim)


def _chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x.chunk(group.size, dim)[group.rank]


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    if dist.get_backend(group.pg) == "gloo":
        x = x.contiguous()
        dist.all_reduce(x, group=group.pg)
        return _chunk(x, dim, group).contiguous()
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // group.size,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group.pg)
    return out.movedim(0, dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, backward):
        ctx.args = (dim, group, backward)
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        dim, group, backward = ctx.args
        if backward == "sum":
            return _reduce_scatter(g, dim, group), None, None, None
        return _chunk(g, dim, group).contiguous(), None, None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group.pg)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group.pg)
        return g, None


def gather_along(x: torch.Tensor, dim: int, group,
                 backward: str = "sum") -> torch.Tensor:
    """The whole tensor of ``group``'s shards of ``x`` along ``dim``."""
    if group.size == 1:
        return x
    return _Gather.apply(x, dim, group, backward)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` (forward); the gradient passes unchanged."""
    if group.size == 1:
        return x
    return _ReduceFrom.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged (forward); its gradient summed over ``group``."""
    if group.size == 1:
        return x
    return _CopyTo.apply(x, group)


def all_gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x``, in rank order (no
    gradient)."""
    if group.size == 1:
        return x[None]
    return _all_gather(x[None], 0, group)
