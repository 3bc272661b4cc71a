"""Collectives that carry autograd, for the mesh steps' explicit schedule.

Each takes a plain local tensor and a :class:`launch.mesh.Group` (one
rank: the tensor itself, both ways).  The tensor-parallel pair is
Megatron's: :func:`reduce_from` sums the partial results of a split
computation (all-reduce forward, identity backward) and :func:`copy_to`
enters one (identity forward, all-reduce of the gradients backward).
:func:`gather_along` all-gathers a sharded weight, or a sequence-sharded
activation, before use; its backward reduce-scatters the gradient
(``"sum"``: the ranks computed on different data or different slices)
or takes this rank's slice of it (``"slice"``: they computed the same
thing).  Megatron's sequence parallelism adds the other two ends:
:func:`reduce_scatter_along` sums a split computation's partials into
this rank's shard (all-gather of the gradient backward) and
:func:`split_along` cuts a whole tensor to this rank's shard (the same
all-gather backward).  gloo has no reduce-scatter, so there it is an
all-reduce and a slice.

Every collective a step issues goes through :func:`_collective`, which
appends a :class:`Collective` to the list that :func:`recording` installs
(the kind the schedule asks for: gloo's reduce-scatter still records as
one) and marks the ops it runs as the collective's own
(:func:`inside_collective`), which the roofline's byte counter leaves to
the collective term.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, List, NamedTuple

import torch
import torch.distributed as dist

#: all-gather into one tensor and reduce-scatter out of one (renamed
#: ``all_gather_single`` / ``reduce_scatter_single`` in newer PyTorch,
#: which warns on the old names)
_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_scatter_from = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


class Collective(NamedTuple):
    """One collective on this rank: its kind (the reference's HLO names:
    ``all-gather``, ``reduce-scatter``, ``all-reduce``), its result's
    bytes on this rank and the size of its group."""
    kind: str
    nbytes: int
    group_size: int


_RECORD: contextvars.ContextVar = contextvars.ContextVar("collectives",
                                                         default=None)
_INSIDE: contextvars.ContextVar = contextvars.ContextVar("in_collective",
                                                         default=False)


@contextlib.contextmanager
def recording() -> Iterator[List[Collective]]:
    """The list of the collectives issued in the block, in order."""
    out: List[Collective] = []
    token = _RECORD.set(out)
    try:
        yield out
    finally:
        _RECORD.reset(token)


def inside_collective() -> bool:
    """Whether the caller runs inside a collective of this module."""
    return _INSIDE.get()


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


@contextlib.contextmanager
def _collective(kind: str, nbytes: int, size: int):
    """Record a collective of ``nbytes`` result bytes over ``size`` ranks
    and mark the block as its own."""
    rec = _RECORD.get()
    if rec is not None:
        rec.append(Collective(kind, nbytes, size))
    token = _INSIDE.set(True)
    try:
        yield
    finally:
        _INSIDE.reset(token)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    with _collective("all-gather", _nbytes(x) * group.size, group.size):
        x = x.movedim(dim, 0).contiguous()
        out = x.new_empty((group.size * x.shape[0],) + tuple(x.shape[1:]))
        _gather_into(out, x, group=group.pg)
        return out.movedim(0, dim)


def _chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x.chunk(group.size, dim)[group.rank]


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    with _collective("reduce-scatter", _nbytes(x) // group.size,
                     group.size):
        if dist.get_backend(group.pg) == "gloo":
            # a copy: the input may be a gradient another branch reads
            x = x.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(x, group=group.pg)
            return _chunk(x, dim, group).contiguous()
        # rank-major: each rank's block of ``dim`` a contiguous chunk, so
        # the result is this rank's block, contiguous
        x = x.unflatten(dim, (group.size, -1)).movedim(dim, 0).contiguous()
        out = x.new_empty(tuple(x.shape[1:]))
        _scatter_from(out, x, group=group.pg)
        return out


def all_reduce(x: torch.Tensor, pg, size: int) -> torch.Tensor:
    """The sum of ``x`` over the process group ``pg`` (None: the default
    group) of ``size`` ranks, without a gradient: a new tensor."""
    with _collective("all-reduce", _nbytes(x), size):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=pg)
        return x


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


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.args = (dim, group)
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        dim, group = ctx.args
        return _all_gather(g, dim, group), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.args = (dim, group)
        return _chunk(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, group = ctx.args
        return _all_gather(g, dim, group), None, None


class _KeepChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.args = (dim, group)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        dim, group = ctx.args
        n = g.shape[dim] // group.size
        out = torch.zeros_like(g)
        out.narrow(dim, group.rank * n, n).copy_(
            g.narrow(dim, group.rank * n, n))
        return out, None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group.pg, group.size)

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
        return all_reduce(g, ctx.group.pg, ctx.group.size), None


def gather_along(x: torch.Tensor, dim: int, group,
                 backward: str = "sum") -> torch.Tensor:
    """The whole tensor of ``group``'s shards of ``x`` along ``dim``."""
    if group.size == 1:
        return x
    return _Gather.apply(x, dim, group, backward)


def reduce_scatter_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's shard along ``dim`` of the sum of ``x`` over ``group``
    (forward); the gradient all-gathered along ``dim``."""
    if group.size == 1:
        return x
    return _ReduceScatter.apply(x, dim, group)


def split_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's shard along ``dim`` of ``x``, which every rank of
    ``group`` holds alike (forward); the gradient all-gathered along
    ``dim``."""
    if group.size == 1:
        return x
    return _Split.apply(x, dim, group)


def keep_chunk_grad(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x`` unchanged (forward); of its gradient, this rank's chunk along
    ``dim`` alone, zeros elsewhere: a whole gradient that a
    :func:`gather_along` ``"sum"`` upstream reduce-scatters then counts
    each chunk once, as ``"slice"`` would (no collective)."""
    if group.size == 1:
        return x
    return _KeepChunk.apply(x, dim, group)


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
