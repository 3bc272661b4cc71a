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
  combine are summed once, in float32;
* the activation between sublayers is batch-local over FSDP and, in the
  train and prefill steps, sequence-sharded over "model" (Megatron SP,
  the reference's ``activation_spec``; ``ParallelConfig.shard_sequence``
  turns it off, the ``no_sp`` variant), where a stack's length divides
  the axis (see :class:`Scope`); otherwise, and in decode, it is whole
  over "model".  The reference's MoE constraints
  (``constrain_moe_tokens``, ``constrain_moe_buffer``) have nothing to
  do and are not ported: its MoE modes share one dispatch
  (``models.moe``).

Under SP each collective of the whole-activation schedule has its
sequence-parallel counterpart (``parallel.comm``):

* a split sublayer's entry (:func:`enter_sublayer`) all-gathers the
  shards along the sequence, the gradient reduce-scattered back
  (``gather_along(x, 1, tp, "sum")``), in place of ``copy_to``;
* its exit (:func:`leave_sublayer`) reduce-scatters the float32 partials
  along the sequence (``reduce_scatter_along``), in place of the
  all-reduce; a sublayer whose heads, columns or channels do not divide
  the axis computes whole on the gathered input and keeps its rank's
  positions (a plain narrow);
* the stack's entry (:func:`shard_sequence`, the embedding's output or
  the encoder's frames) cuts the whole activation to the rank's shard
  (``split_along``: the gradient all-gathered, so the embedding's
  gradient is whole on every "model" rank, as ``full_param`` assumes);
* its exit (:func:`gather_sequence`) runs the final norm on the shard
  and all-gathers it with backward ``"slice"``: the head, the loss and
  an encoder's cross-attention source are whole on every "model" rank.
  Prefill gathers only each shard's last row: the last rank's is the
  last position.

The gradient rules follow.  A parameter applied to sequence-sharded
tokens -- every norm's ``scale``, whisper's ``bo``, the whole weights of
a sublayer that does not split -- gets only its shard's gradient on each
"model" rank, so :func:`full` with ``partial=True`` sums it over "model"
there (reduce-scatter where its spec shards it over "model", all-reduce
where it is whole).  Inside a split sublayer the gathered input's
gradient is each rank's share, so nothing may sum it over "model" as
well: the MoE router, which every rank runs alike, keeps its gradient to
the rank's own positions (:func:`replicated`), and the kv heads a rank's
query heads share are taken without a ``copy_to``.

Gradients flow through every collective (``parallel.comm``).  The loss
is the global batch's: each rank's gradient is its own batch's share,
and the replicated weights' gradients are summed over the batch axes.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch

from . import comm
from .sharding import ParallelConfig, Spec, activation_spec, spec_axes

TP = "model"


@dataclass
class Scope:
    """What a mesh step's call needs: the mesh, the knobs, each
    parameter's spec (by name), the batch's axes, whether the caches'
    sequence axis is sharded (over ``pcfg.cache_seq_axis``) and whether
    the step takes sequence parallelism (``seq_parallel``: the train and
    prefill steps under ``pcfg.shard_sequence``); this rank's groups over
    "model", the batch's axes and the caches' sequence axes, and each
    parameter's gathers, found once (a decode step reads every weight,
    and its host time is the step's).

    SP is on exactly where the reference's ``activation_spec`` puts
    "model" on the sequence axis: in a step with ``seq_parallel``, on a
    "model" axis of more than one rank, for a stack whose own length
    divides it.  Each stack decides for itself
    (:func:`sequence_sharded`): whisper-base's 1,500 encoder frames do
    not divide 16, so on the production mesh its encoder runs whole and
    its decoder sharded.  Inside such a stack the scope is a copy with
    ``sharded`` set."""
    mesh: object
    pcfg: ParallelConfig
    specs: Mapping[str, Spec]
    batch_axes: Tuple[str, ...]
    cache_seq: bool = False
    seq_parallel: bool = False
    sharded: bool = False
    _plans: Dict[Tuple[str, Optional[str]], tuple] = field(
        default_factory=dict, repr=False)

    def __post_init__(self):
        self.tp = self.mesh.group(TP)
        self.batch = self.mesh.group(self.batch_axes)
        self.seq = self.mesh.group(spec_axes(self.pcfg.cache_seq_axis))

    def plan(self, name: str, tp: Optional[str]) -> tuple:
        """The gathers that make parameter ``name`` whole over the FSDP
        axes (and over "model" unless ``tp`` is None, the gradient taken
        by ``tp``: ``"slice"`` or ``"sum"``), as (dim, group, backward)
        steps, and the group over which its gradient is summed besides
        (None: none) -- over "model" too where ``tp`` is ``"sum"`` and
        the spec leaves it whole there."""
        key = (name, tp)
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
            if tp is not None:
                tp_dims = [d for d, e in enumerate(self.specs[name])
                           if TP in spec_axes(e)]
                steps += [(d, self.tp, tp) for d in tp_dims]
                if tp == "sum" and not tp_dims:
                    rest |= {TP}
            rest = self.mesh.group(tuple(rest)) if rest else None
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


@contextlib.contextmanager
def sequence_sharded(n: int) -> Iterator[bool]:
    """For the block, a stack of ``n`` positions runs sequence-sharded
    over "model" where the step's SP applies to it (see :class:`Scope`);
    yields whether it does."""
    sc = current()
    if (sc is None or not sc.seq_parallel
            or activation_spec(sc.mesh, 1, n, sc.pcfg)[1] is None):
        yield False
        return
    sub = copy.copy(sc)      # the groups and the plans shared
    sub.sharded = True
    with activation_sharding_scope(sub):
        yield True


def sharded() -> bool:
    """Whether the activations in flight are sequence-sharded."""
    sc = current()
    return sc is not None and sc.sharded


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
              tp: Optional[str]) -> torch.Tensor:
    """``t`` gathered over the FSDP axes its spec shards it on (and over
    "model" unless ``tp`` is None); the gradient summed over the batch's
    axes (reduce-scattered where the weight is sharded over them,
    all-reduced where it is whole) and, over "model", taken by ``tp``
    (``"slice"``; ``"sum"``: reduce-scattered, or all-reduced where the
    weight is whole over "model")."""
    steps, rest = sc.plan(name, tp)
    for d, group, backward in steps:
        t = comm.gather_along(t, d, group, backward)
    return t if rest is None else comm.copy_to(t, rest)


def full_param(name: str, t: torch.Tensor,
               partial: bool = False) -> torch.Tensor:
    """The whole parameter ``name`` from its local shard ``t``, for a
    computation every "model" rank makes alike (norms, router,
    embeddings, the head, a sublayer that does not split).  ``partial``:
    under SP the computation sees only this rank's positions (a norm, a
    bias added on the shard, a sublayer whose output keeps the rank's
    positions), so the gradient here is this rank's share and is summed
    over "model"; without SP it is whole and is not."""
    sc = current()
    if sc is None:
        return t
    return _gathered(sc, name, t, "sum" if partial and sc.sharded
                     else "slice")


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
    t = _gathered(sc, name, t, None)
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


def full(module, attr: str, partial: bool = False) -> torch.Tensor:
    """:func:`full_param` of ``module``'s parameter ``attr``."""
    return full_param(_name(module, attr), getattr(module, attr), partial)


def part(module, attr: str, dim: int,
         ranges: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """:func:`part_param` of ``module``'s parameter ``attr``."""
    return part_param(_name(module, attr), getattr(module, attr), dim,
                      ranges)


def enter_split(x: torch.Tensor) -> torch.Tensor:
    """A replicated tensor entering a split computation."""
    sc = current()
    return x if sc is None else comm.copy_to(x, sc.tp)


def leave_split(x: torch.Tensor) -> torch.Tensor:
    """The sum of a split computation's partial results (inside a
    sublayer: a sum over the split units that the sublayer reads
    whole)."""
    sc = current()
    return x if sc is None else comm.reduce_from(x, sc.tp)


def enter_sublayer(x: torch.Tensor, split: bool,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A sublayer's (B, S, D) input as (whole, entering the split): under
    SP the shards gathered along the sequence, both (the gradient
    reduce-scattered back, so what reads it must leave each rank's
    gradient its share); else ``x`` and, where the sublayer splits over
    "model", ``x`` entering the split."""
    sc = current()
    if sc is None:
        return x, x
    if sc.sharded:
        # contiguous, as the whole activation is, for the projections
        x = comm.gather_along(x, 1, sc.tp, "sum").contiguous()
        return x, x
    return x, (comm.copy_to(x, sc.tp) if split else x)


def leave_sublayer(y: torch.Tensor, split: bool) -> torch.Tensor:
    """A sublayer's (B, S, D) output: where it splits over "model", the
    sum of the partials (``y``, float32), reduce-scattered along the
    sequence under SP and all-reduced otherwise; where it does not, ``y``
    itself, of which SP keeps the rank's positions."""
    sc = current()
    if sc is None:
        return y
    if sc.sharded:
        if split:
            return comm.reduce_scatter_along(y, 1, sc.tp)
        n = y.shape[1] // sc.tp.size
        return y.narrow(1, sc.tp.rank * n, n)
    return comm.reduce_from(y, sc.tp) if split else y


def replicated(x: torch.Tensor) -> torch.Tensor:
    """A sublayer's gathered input for a computation that every "model"
    rank makes alike and whose gradient is whole on each (the MoE router:
    its aux losses are every rank's): under SP the gradient is kept to
    the rank's own positions, so the gather's reduce-scatter counts it
    once; else ``x``."""
    sc = current()
    if sc is None or not sc.sharded:
        return x
    return comm.keep_chunk_grad(x, 1, sc.tp)


def shard_sequence(x: torch.Tensor) -> torch.Tensor:
    """A stack's whole (B, S, D) input cut to this rank's positions under
    SP (the gradient all-gathered back); else ``x``."""
    sc = current()
    if sc is None or not sc.sharded:
        return x
    return comm.split_along(x, 1, sc.tp)


def gather_sequence(x: torch.Tensor) -> torch.Tensor:
    """A stack's sequence-sharded output made whole on every "model" rank
    under SP, for what every rank computes alike after it (the gradient
    sliced back); else ``x``."""
    sc = current()
    if sc is None or not sc.sharded:
        return x
    return comm.gather_along(x, 1, sc.tp, "slice").contiguous()


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
