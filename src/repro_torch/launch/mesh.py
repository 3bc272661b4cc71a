"""Meshes: abstract ones for the sharding rules, and meshes over ranks.

Counterpart of ``src/repro/launch/mesh.py``.  Three kinds of mesh, each
with the reference mesh's ``axis_names`` and ``shape`` (axis -> size), so
the rules of ``parallel.sharding`` take any of them:

* :class:`AbstractMesh` -- axis names and sizes, no device and no
  process group (JAX's ``AbstractMesh``): the production meshes can be
  reasoned about in one process.
* :class:`HostMesh` -- one device, no process group: what the training
  loop, the examples and the one-device steps run under (every axis of
  size 1); it names its device (the card unless the caller names the
  CPU) and makes it the current CUDA device inside its ``with`` block.
* :class:`RankMesh` -- the ranks of an initialised ``torch.distributed``
  process group laid out row-major over the axes (NCCL on the card, gloo
  on the CPU); it keeps one process group for each set of its axes a
  collective spans, which the steps' explicit schedule uses (no
  ``torch.distributed`` device mesh is built: nothing places DTensors).
  A mesh that needs more ranks than the group has raises, naming
  both counts; none is ever built smaller.

The production shapes are the reference's: (16, 16) over ("data",
"model") and (2, 16, 16) over ("pod", "data", "model").
"""

from __future__ import annotations

import contextlib
import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

#: the reference's production shapes
POD_SHAPE = (16, 16)
POD_AXES = ("data", "model")
MULTI_POD_AXES = ("pod", "data", "model")


class _Axes:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


@dataclass(frozen=True)
class AbstractMesh(_Axes):
    """Axis sizes and names with no device behind them.

    >>> AbstractMesh((2, 16, 16), ("pod", "data", "model")).shape["pod"]
    2
    """
    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.sizes} and axes "
                             f"{self.axis_names} differ in length")


@dataclass
class HostMesh(_Axes):
    """A one-device mesh: every axis of size 1, no process group."""
    device: torch.device
    axis_names: Tuple[str, ...] = POD_AXES

    @property
    def sizes(self) -> Tuple[int, ...]:
        return (1,) * len(self.axis_names)

    def __enter__(self) -> "HostMesh":
        self._ctx = (torch.cuda.device(self.device)
                     if self.device.type == "cuda"
                     else contextlib.nullcontext())
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._ctx.__exit__(*exc)


@dataclass(frozen=True)
class Group:
    """This rank's process group over some axes of a mesh: ``pg`` (None
    for one rank), the rank's index in it and its size."""
    pg: Optional[object]
    rank: int
    size: int


@dataclass
class RankMesh(HostMesh):
    """The ranks of the initialised process group as a mesh."""
    sizes: Tuple[int, ...] = ()
    rank: int = 0
    _groups: Dict[Tuple[str, ...], Group] = field(default_factory=dict,
                                                  repr=False)

    @property
    def coords(self) -> Dict[str, int]:
        """axis -> this rank's index along it (row-major rank layout)."""
        out, r = {}, self.rank
        for a, n in reversed(list(zip(self.axis_names, self.sizes))):
            out[a] = r % n
            r //= n
        return out

    def group(self, axes) -> Group:
        """This rank's group over ``axes`` (a name or names; the mesh's
        order); one rank when they span a single rank."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        axes = tuple(a for a in self.axis_names if a in axes)
        return self._groups[axes]

    def _make_groups(self) -> None:
        """One process group for every set of axes and every position of
        the others.  ``dist.new_group`` is collective, so every rank makes
        every group, in the same order."""
        names = self.axis_names
        for n in range(1, len(names) + 1):
            for axes in itertools.combinations(names, n):
                size = math.prod(self.shape[a] for a in axes)
                if size == 1:
                    self._groups[axes] = Group(None, 0, 1)
                    continue
                others = [a for a in names if a not in axes]
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in others)):
                    ranks = [r for r in range(self.size)
                             if all(self._coord(r, a) == v
                                    for a, v in zip(others, fixed))]
                    pg = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = Group(
                            pg, ranks.index(self.rank), size)
        self._groups[()] = Group(None, 0, 1)

    def _coord(self, rank: int, axis: str) -> int:
        i = self.axis_names.index(axis)
        return rank // math.prod(self.sizes[i + 1:]) % self.sizes[i]

    def barrier(self) -> None:
        dist.barrier()


def _local_device(device) -> torch.device:
    """A rank's device: ``cuda:(rank % cards)`` for the card (None or an
    unnumbered "cuda"), else the device named."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return dev


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device=None):
    """A mesh of ``shape`` over ``axes`` on the ranks of the process
    group (tests use small ones, e.g. (2, 2)).  Without a process group
    a mesh of one rank is the :class:`HostMesh` of ``device``; any other
    needs a group of exactly its size, and raises naming both counts."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if not dist.is_initialized() and need == 1:
        return HostMesh(resolve_device(device), axes)
    if have != need:
        raise ValueError(
            f"a mesh of shape {shape} over {axes} needs {need} ranks, but "
            f"the process group has {have}"
            + ("" if dist.is_initialized() else
               " (none is initialised: call torch.distributed."
               "init_process_group first)"))
    dev = _local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = RankMesh(device=dev, axis_names=axes, sizes=shape,
                    rank=dist.get_rank())
    mesh._make_groups()
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production mesh: (16, 16) over ("data", "model"),
    or (2, 16, 16) over ("pod", "data", "model") with ``multi_pod``; it
    needs a process group of 256 or 512 ranks."""
    return make_mesh(*production_shape(multi_pod=multi_pod), device=device)


def production_shape(*, multi_pod: bool = False,
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(sizes, axes) of the production mesh."""
    if multi_pod:
        return (2,) + POD_SHAPE, MULTI_POD_AXES
    return POD_SHAPE, POD_AXES


def make_host_mesh(device=None, *, model_parallel: Optional[int] = None):
    """The mesh over whatever ranks exist: with a process group of more
    than one rank, (ranks / model_parallel, model_parallel) over ("data",
    "model"); otherwise the one-device :class:`HostMesh` on ``device``
    (None: the card, which raises without one; pass ``device="cpu"`` for
    the CPU)."""
    mp = model_parallel or 1
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % mp:
        raise ValueError(f"model_parallel={mp} does not divide the "
                         f"{n} ranks of the process group")
    if n == 1:
        return HostMesh(resolve_device(device))
    return make_mesh((n // mp, mp), POD_AXES, device)


def elastic_mesh(n_failed_replicas: int = 0, *, multi_pod: bool = False,
                 device=None):
    """Re-mesh after losing data-parallel replicas (elastic scaling): the
    production mesh with ``n_failed_replicas`` rows fewer on its data
    axis, on a process group of that many ranks."""
    data = POD_SHAPE[0] - n_failed_replicas
    if data < 1:
        raise ValueError("no data-parallel replicas left")
    if multi_pod:
        return make_mesh((2, data, POD_SHAPE[1]), MULTI_POD_AXES, device)
    return make_mesh((data, POD_SHAPE[1]), POD_AXES, device)
