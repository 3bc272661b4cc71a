"""The sharding context of a mesh step, and the model's view of it.

Counterpart of ``src/repro/parallel/context.py``.  The model code is
mesh-agnostic; a step built on a :class:`launch.mesh.RankMesh` installs a
:class:`Scope` with :func:`activation_sharding_scope` around its call,
and the layers read their weights and cross ranks through the functions
below.  Outside a scope every one of them returns its input: the
one-device path is untouched.

The reference's constraints are placement hints to GSPMD, which plans
the collectives.  The port plans them itself, as one explicit schedule
over plain local tensors (the kernels never see a DTensor):

* a layer's weights are all-gathered over the FSDP axes just before use
  (:func:`full`, :func:`part`; the gradient reduce-scattered back);
* attention heads, MLP columns, Mamba ``d_inner`` channels and MoE
  experts stay local over "model" (:func:`tp_split`); the partial sums of
  ``wo``, ``wd`` / ``wo_mlp``, ``x_proj`` and ``out_proj`` and of the MoE
  combine are all-reduced once, in float32 (:func:`leave_split`);
* the activation between layers is batch-local over FSDP and whole over
  "model" in every mode, so the reference's constraints
  (``constrain_activations``, ``constrain_moe_tokens``,
  ``constrain_moe_buffer``) have nothing to do and are not ported: the
  port does not take the reference's sequence sharding between
  superblocks (Megatron SP), a memory lever that computes the same
  function, and its MoE modes share one dispatch (``models.moe``).

Gradients flow through every collective (``parallel.comm``).  The loss
is the global batch's: each rank's gradient is its own batch's share,
and the replicated weights' gradients are summed over the batch axes.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch

from . import comm
from .sharding import ParallelConfig, Spec, spec_axes

TP = "model"


@dataclass
class Scope:
    """What a mesh step's call needs: the mesh, the knobs, each
    parameter's spec (by name), the batch's axes and whether the caches'
    sequence axis is sharded (over ``pcfg.cache_seq_axis``); this rank's
    groups over "model", the batch's axes and the caches' sequence axes,
    and each parameter's gathers, found once (a decode step reads every
    weight, and its host time is the step's)."""
    mesh: object
    pcfg: ParallelConfig
    specs: Mapping[str, Spec]
    batch_axes: Tuple[str, ...]
    cache_seq: bool = False
    _plans: Dict[Tuple[str, bool], tuple] = field(default_factory=dict,
                                                  repr=False)

    def __post_init__(self):
        self.tp = self.mesh.group(TP)
        self.batch = self.mesh.group(self.batch_axes)
        self.seq = self.mesh.group(spec_axes(self.pcfg.cache_seq_axis))

    def plan(self, name: str, tp_whole: bool) -> tuple:
        """The gathers that make parameter ``name`` whole over the FSDP
        axes (and over "model" with ``tp_whole``), as (dim, group,
        backward) steps, and the group over which its gradient is summed
        besides (None: none)."""
        key = (name, tp_whole)
        if key not in self._plans:
            batch = set(self.batch_axes)
            steps, done = [], set()
            for d, entry in enumerate(self.specs[name]):
                axes = tuple(a for a in spec_axes(entry) if a != TP)
                if axes:
                    steps.append((d, self.mesh.group(axes), "sum"
                                  if set(axes) <= batch else "slice"))
                    done |= set(axes)
            rest = batch - done
            rest = self.mesh.group(tuple(rest)) if rest else None
            if tp_whole:
                steps += [(d, self.tp, "slice")
                          for d, e in enumerate(self.specs[name])
                          if TP in spec_axes(e)]
            self._plans[key] = (tuple(s for s in steps if s[1].size > 1),
                                rest if rest and rest.size > 1 else None)
        return self._plans[key]


_SCOPE: contextvars.ContextVar = contextvars.ContextVar("mesh_scope",
                                                        default=None)


@contextlib.contextmanager
def activation_sharding_scope(scope: Optional[Scope]) -> Iterator[None]:
    """Install ``scope`` (None: none) for the block."""
    token = _SCOPE.set(scope)
    try:
        yield
    finally:
        _SCOPE.reset(token)


def current() -> Optional[Scope]:
    return _SCOPE.get()


# ---------------------------------------------------------------------------
# the model's view: splits, weights, activations
# ---------------------------------------------------------------------------

def tp_split(n: int) -> Optional[Tuple[int, int]]:
    """(rank, size) over "model" when ``n`` units (heads, columns,
    channels, experts) split evenly over more than one rank; None
    otherwise (off a mesh: never)."""
    sc = current()
    if sc is None:
        return None
    tp = sc.tp
    if tp.size == 1 or n % tp.size:
        return None
    return tp.rank, tp.size


def _gathered(sc: Scope, name: str, t: torch.Tensor,
              tp_whole: bool) -> torch.Tensor:
    """``t`` gathered over the FSDP axes its spec shards it on (and over
    "model" with ``tp_whole``); the gradient summed over the batch's axes
    (reduce-scattered where the weight is sharded over them, all-reduced
    where it is whole) and, over "model", sliced."""
    steps, rest = sc.plan(name, tp_whole)
    for d, group, backward in steps:
        t = comm.gather_along(t, d, group, backward)
    return t if rest is None else comm.copy_to(t, rest)


def full_param(name: str, t: torch.Tensor) -> torch.Tensor:
    """The whole parameter ``name`` from its local shard ``t``, for a
    computation every "model" rank makes alike (norms, router,
    embeddings, the head)."""
    sc = current()
    return t if sc is None else _gathered(sc, name, t, True)


def part_param(name: str, t: torch.Tensor, dim: int,
               ranges: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """The ``ranges`` of dimension ``dim`` of parameter ``name`` (joined)
    for this rank's share of a split computation: its local shard where
    the spec stores exactly that share; else gathered over "model" (the
    gradient reduce-scattered) or, where it is whole there, its gradient
    summed over "model"."""
    sc = current()
    if sc is None:
        return _take(t, dim, ranges)
    spec = sc.specs[name]
    t = _gathered(sc, name, t, False)
    tp_dims = [d for d, e in enumerate(spec) if TP in spec_axes(e)]
    if tp_dims == [dim]:
        c = t.shape[dim]
        if list(ranges) == [(sc.tp.rank * c, (sc.tp.rank + 1) * c)]:
            return t
    if tp_dims:
        for d in tp_dims:
            t = comm.gather_along(t, d, sc.tp, "sum")
    else:
        t = comm.copy_to(t, sc.tp)
    return _take(t, dim, ranges)


def _take(t: torch.Tensor, dim: int,
          ranges: Sequence[Tuple[int, int]]) -> torch.Tensor:
    if len(ranges) == 1 and tuple(ranges[0]) == (0, t.shape[dim]):
        return t
    return torch.cat([t.narrow(dim, lo, hi - lo) for lo, hi in ranges], dim)


def _name(module, attr: str) -> str:
    return getattr(module, "_pname", "") + attr


def full(module, attr: str) -> torch.Tensor:
    """:func:`full_param` of ``module``'s parameter ``attr``."""
    return full_param(_name(module, attr), getattr(module, attr))


def part(module, attr: str, dim: int,
         ranges: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """:func:`part_param` of ``module``'s parameter ``attr``."""
    return part_param(_name(module, attr), getattr(module, attr), dim,
                      ranges)


def enter_split(x: torch.Tensor) -> torch.Tensor:
    """A replicated activation entering a split computation."""
    sc = current()
    return x if sc is None else comm.copy_to(x, sc.tp)


def leave_split(x: torch.Tensor) -> torch.Tensor:
    """The sum of a split computation's partial results."""
    sc = current()
    return x if sc is None else comm.reduce_from(x, sc.tp)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the batch's ranks (a loss's token sums)."""
    sc = current()
    return x if sc is None else comm.reduce_from(x, sc.batch)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the batch's ranks (each holds an equal
    share of the batch)."""
    sc = current()
    if sc is None or sc.batch.size == 1:
        return x
    return comm.reduce_from(x, sc.batch) / sc.batch.size


def seq_split() -> Optional[Tuple[int, int, object]]:
    """(rank, size, group) of the caches' sequence axis where a decode
    step shards it (``cache_seq_axis`` at batch 1), else None."""
    sc = current()
    if sc is None or not sc.cache_seq:
        return None
    g = sc.seq
    return (g.rank, g.size, g) if g.size > 1 else None


def ranges_of(rank: int, size: int, n: int,
              offsets: Sequence[int] = (0,)) -> List[Tuple[int, int]]:
    """Rank ``rank`` of ``size``'s equal block of ``n`` units, at each of
    ``offsets`` (a fused projection's parts)."""
    c = n // size
    return [(o + rank * c, o + (rank + 1) * c) for o in offsets]
