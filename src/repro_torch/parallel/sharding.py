"""Sharding rules of the port: parameter, batch, activation and cache
specs by name, and the replica devices of the CTMC engines.

Counterpart of ``src/repro/parallel/sharding.py``; two surfaces, as there:

* **Model rules** (:class:`ParallelConfig`, :func:`param_spec`,
  :func:`params_shardings`, :func:`batch_spec`, :func:`batch_shardings`,
  :func:`activation_spec`, :func:`cache_shardings`,
  :func:`opt_state_shardings`): pure functions of (name, shape, mesh), so
  they are checked without devices on an abstract mesh
  (``launch.mesh.AbstractMesh``).  A spec is the reference's
  ``PartitionSpec`` as a tuple, one entry a tensor dimension: None, an
  axis name, or a tuple of axis names (major first), a one-name tuple
  written as the name, as ``tuple(PartitionSpec(...))`` gives it.  FSDP
  shards over ("pod", "data"), TP over "model"; a dimension that does not
  divide its axes' size stays whole.  The port's parameters are unstacked
  (``stack.{i}.attn.wq``), so a layer's rule is the reference's rule for
  its stacked path with the leading None dropped.  :func:`local_slice` is
  the part of a whole tensor one rank holds under a spec (the port runs
  an explicit schedule over plain local tensors, not DTensors).
* **Replica devices** (:data:`REPLICA_AXIS`, :func:`replica_mesh`,
  :func:`shard_seeds`, :func:`replica_state_specs`), below.

The reference splits the replica axis of a CTMC batch over a
``shard_map`` mesh; the port gives each shard its own
device and drives the shards' chunked scans side by side
(``core.vectorized._run_sharded``): on the card shard ``s`` runs
on ``cuda:s``, one card a shard; on the CPU the shards run in turn on the
one host device.  There are no collectives: each shard's replicas are
independent, and concatenating the shards' replica axes is the merge.

Seeds take the place of the reference's threefry keys, whose bits torch
cannot reproduce: ``shard_seeds(seed, 1)`` is ``[seed]`` itself, so a
one-shard run is the unsharded run bit for bit, and ``n > 1`` shards get
seeds folded from ``(seed, s)``, so shard ``s`` of a sharded run is an
independent unsharded run over its replicas seeded ``shard_seeds(seed,
n)[s]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import (Any, Dict, Iterable, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

Axes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axes, ...]


@dataclass(frozen=True)
class ParallelConfig:
    """Knobs for the distribution strategy (the reference's levers)."""
    shard_sequence: bool = True          # Megatron-style SP between blocks
    shard_embed_vocab: bool = True       # vocab dim of embed/head over TP
    fsdp_params: bool = True             # shard params over (pod, data)
    cache_seq_axis: Optional[Axes] = None  # shard cache seq (long decode)
    moe_buffer_mode: str = "ep"          # ep | dp | none | ep_local |
    #                                      shard_map (parallel.context)


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], str]:
    """-> (fsdp_axes, tp_axis) present in this mesh."""
    names = mesh.axis_names
    fsdp = tuple(a for a in ("pod", "data") if a in names)
    return fsdp, "model"


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


def _shard_if(mesh, dim: int, axes) -> Axes:
    """Return ``axes`` if dim divides the axis-product size, else None."""
    if axes is None:
        return None
    size = _axis_size(mesh, axes)
    return axes if (size > 1 and dim % size == 0) else None


def _spec(*entries: Axes) -> Spec:
    """A spec as ``tuple(PartitionSpec(*entries))`` holds it: a tuple of
    one axis name becomes the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def spec_axes(entry: Axes) -> Tuple[str, ...]:
    """The axis names of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

def param_spec(name: str, shape: Sequence[int], mesh,
               pcfg: ParallelConfig = ParallelConfig()) -> Spec:
    """The spec of one parameter, by its name in the port's state dict.

    A layer's parameter (``stack.{i}...``, ``encoder.stack.{i}...``) takes
    the reference's rule for the stacked leaf with the leading superblock
    axis dropped; its ``shape`` is the reference's per-layer ``dims``."""
    fsdp, tp = mesh_axes(mesh)
    if not pcfg.fsdp_params:
        fsdp = ()
    fsdp = fsdp or None
    leaf = name.split(".")[-1]
    shape = tuple(shape)
    dims = shape

    def spec(*parts):
        if len(parts) != len(shape):
            raise ValueError(f"param_spec: {name} {shape} has no rule of "
                             f"{len(parts)} dimensions")
        return _spec(*parts)

    def whole():
        return _spec(*([None] * len(shape)))

    # -- embeddings / head -------------------------------------------------
    if name == "embed":
        v_ax = _shard_if(mesh, shape[0], tp) if pcfg.shard_embed_vocab \
            else None
        return _spec(v_ax, _shard_if(mesh, shape[1], fsdp))
    if name == "head":
        v_ax = _shard_if(mesh, shape[1], tp) if pcfg.shard_embed_vocab \
            else None
        return _spec(_shard_if(mesh, shape[0], fsdp), v_ax)
    if name == "img_proj":
        return _spec(None, _shard_if(mesh, shape[1], tp))

    # -- norms / scalars ---------------------------------------------------
    if leaf in ("scale", "step") or leaf.startswith("norm"):
        return whole()

    # -- attention -----------------------------------------------------------
    if leaf in ("wq", "wk", "wv"):
        return spec(_shard_if(mesh, dims[0], fsdp),
                    _shard_if(mesh, dims[1], tp), None)
    if leaf == "wo":
        return spec(_shard_if(mesh, dims[0], tp), None,
                    _shard_if(mesh, dims[2], fsdp))
    if leaf in ("bq", "bk", "bv"):
        return spec(_shard_if(mesh, dims[0], tp), None)

    # -- dense MLP and MoE experts -------------------------------------------
    if leaf in ("wg", "wu", "wi"):
        if len(dims) == 3:  # MoE expert weights (E, D, F)
            return spec(_shard_if(mesh, dims[0], tp),
                        _shard_if(mesh, dims[1], fsdp), None)
        return spec(_shard_if(mesh, dims[0], fsdp),
                    _shard_if(mesh, dims[1], tp))
    if leaf in ("wd", "wo_mlp"):
        if len(dims) == 3:  # MoE expert down (E, F, D)
            return spec(_shard_if(mesh, dims[0], tp), None,
                        _shard_if(mesh, dims[2], fsdp))
        return spec(_shard_if(mesh, dims[0], tp),
                    _shard_if(mesh, dims[1], fsdp))
    if leaf in ("bi", "bo"):
        return spec(_shard_if(mesh, dims[0], tp))
    if leaf == "router":
        return spec(_shard_if(mesh, dims[0], fsdp), None)

    # -- mamba -------------------------------------------------------------------
    if leaf == "in_proj":
        return spec(_shard_if(mesh, dims[0], fsdp),
                    _shard_if(mesh, dims[1], tp))
    if leaf == "out_proj":
        return spec(_shard_if(mesh, dims[0], tp),
                    _shard_if(mesh, dims[1], fsdp))
    if leaf in ("conv_w", "dt_w"):
        return spec(None, _shard_if(mesh, dims[1], tp))
    if leaf in ("conv_b", "dt_b", "D"):
        return spec(_shard_if(mesh, dims[0], tp))
    if leaf in ("x_proj", "A_log"):
        return spec(_shard_if(mesh, dims[0], tp), None)
    return whole()


def params_shardings(params_spec_tree: Mapping[str, Any], mesh,
                     pcfg: ParallelConfig = ParallelConfig(),
                     ) -> Dict[str, Spec]:
    """The spec of every parameter of a state dict (tensors or
    ``TensorSpec``s, by name)."""
    return {k: param_spec(k, tuple(v.shape), mesh, pcfg)
            for k, v in params_spec_tree.items()}


# ---------------------------------------------------------------------------
# activation / batch / cache rules
# ---------------------------------------------------------------------------

def batch_spec(mesh, global_batch: int,
               pcfg: ParallelConfig = ParallelConfig()) -> Spec:
    fsdp, _ = mesh_axes(mesh)
    return _spec(_shard_if(mesh, global_batch, fsdp), None)


def batch_shardings(batch_tree: Any, mesh,
                    pcfg: ParallelConfig = ParallelConfig()) -> Any:
    """Shard every batch input on its leading (batch) dim; a dict of
    inputs gives a dict of specs, one input its spec."""
    fsdp, _ = mesh_axes(mesh)

    def leaf(sds):
        if len(sds.shape) == 0:
            return ()
        ax = _shard_if(mesh, sds.shape[0], fsdp)
        return _spec(ax, *([None] * (len(sds.shape) - 1)))

    if isinstance(batch_tree, Mapping):
        return {k: leaf(v) for k, v in batch_tree.items()}
    return leaf(batch_tree)


def activation_spec(mesh, batch: int, seq: int,
                    pcfg: ParallelConfig = ParallelConfig()) -> Spec:
    """(B, S, D) boundary-activation spec: batch over FSDP, seq over TP."""
    fsdp, tp = mesh_axes(mesh)
    b_ax = _shard_if(mesh, batch, fsdp)
    s_ax = _shard_if(mesh, seq, tp) if pcfg.shard_sequence else None
    return _spec(b_ax, s_ax, None)


def cache_shardings(cache_spec_tree: Sequence[Mapping[str, Any]], mesh,
                    pcfg: ParallelConfig = ParallelConfig(),
                    ) -> List[Dict[str, Dict[str, Spec]]]:
    """KV/SSM cache specs, one dict a layer as the port's caches hold
    them (the reference's rules without the superblock axis):

    Attention k/v (self and cross): (B, S_max, Hkv, hd) -> (fsdp, [seq],
    tp, None); Mamba conv: (B, W-1, di) -> (fsdp, None, tp); Mamba ssm:
    (B, di, N) -> (fsdp, tp, None).  When the batch does not divide the
    FSDP axes (batch 1: long-context decode) the batch axis is whole and
    the sequence axis takes ``pcfg.cache_seq_axis`` if set.
    """
    fsdp, tp = mesh_axes(mesh)

    def attn(sds):
        B, S, H, _ = sds.shape
        b_ax = _shard_if(mesh, B, fsdp)
        s_ax = (_shard_if(mesh, S, pcfg.cache_seq_axis)
                if (b_ax is None and pcfg.cache_seq_axis) else None)
        return _spec(b_ax, s_ax, _shard_if(mesh, H, tp), None)

    def ssm(key, sds):
        b_ax = _shard_if(mesh, sds.shape[0], fsdp)
        if key == "conv":
            return _spec(b_ax, None, _shard_if(mesh, sds.shape[2], tp))
        return _spec(b_ax, _shard_if(mesh, sds.shape[1], tp), None)

    return [{kind: {k: ssm(k, v) if kind == "ssm" else attn(v)
                    for k, v in entries.items()}
             for kind, entries in layer.items()}
            for layer in cache_spec_tree]


def opt_state_shardings(opt_spec_tree: Any, param_shardings: Mapping[str, Spec],
                        mesh) -> Dict[str, Any]:
    """Adam m/v mirror the parameter shardings; step is replicated."""
    return {"m": dict(param_shardings), "v": dict(param_shardings),
            "step": ()}


# ---------------------------------------------------------------------------
# a spec on a device mesh
# ---------------------------------------------------------------------------

def _mesh_order(mesh, entry: Axes) -> Tuple[str, ...]:
    axes = spec_axes(entry)
    return tuple(a for a in mesh.axis_names if a in axes)


def local_slice(spec: Spec, shape: Sequence[int], mesh,
                coords: Mapping[str, int]) -> Tuple[slice, ...]:
    """The index of the part of a whole ``shape`` tensor that the rank at
    ``coords`` (axis -> index) holds under ``spec``."""
    out = []
    for d, entry in enumerate(spec):
        axes = _mesh_order(mesh, entry)
        n = _axis_size(mesh, axes or None)
        if shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"divide over {axes} ({n} ranks)")
        i = 0
        for a in axes:
            i = i * mesh.shape[a] + coords[a]
        c = shape[d] // n
        out.append(slice(i * c, (i + 1) * c))
    return tuple(out)


def place(tree: Any, shardings: Any, mesh) -> Any:
    """This rank's part of a tree of whole tensors (dicts and lists of
    them, as the specs' tree), on the mesh's device; a leaf that is not a
    tensor (a position) passes through.  On a one-rank mesh, and where
    the rank holds a whole tensor, the part is the tensor itself (moved,
    if need be): its in-place updates are the caller's."""
    if isinstance(tree, Mapping):
        return {k: place(v, shardings[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [place(v, s, mesh) for v, s in zip(tree, shardings)]
    if not isinstance(tree, torch.Tensor):
        return tree
    t = tree.to(mesh.device)
    if mesh.size == 1:
        return t
    idx = local_slice(shardings, t.shape, mesh, mesh.coords)
    if all(i.stop - i.start == n for i, n in zip(idx, t.shape)):
        return t
    return t[idx].clone()


def gather(tree: Any, shardings: Any, mesh) -> Any:
    """The whole tensors of a tree of this rank's parts (the inverse of
    :func:`place`; a collective: every rank calls it)."""
    if isinstance(tree, Mapping):
        return {k: gather(v, shardings[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather(v, s, mesh) for v, s in zip(tree, shardings)]
    if not isinstance(tree, torch.Tensor) or mesh.size == 1:
        return tree
    from .comm import _all_gather
    for d, entry in enumerate(shardings):
        axes = _mesh_order(mesh, entry)
        if axes and _axis_size(mesh, axes) > 1:
            tree = _all_gather(tree, d, mesh.group(axes))
    return tree


# ---------------------------------------------------------------------------
# simulator replica devices (the CTMC engines' shard axis)
# ---------------------------------------------------------------------------

#: the replica-axis name; every batched lane of a CTMC state splits its
#: replica dimension over it
REPLICA_AXIS = "r"


def replica_mesh(n_shards: int, device) -> List[torch.device]:
    """The devices of an ``n_shards``-shard run on ``device``'s kind.

    On the card shard ``s`` runs on ``cuda:s`` (one shard on the caller's
    own device); more shards than ``torch.cuda.device_count()`` raise,
    naming both counts -- a sharded run never de-shards.  On the CPU the
    shards run in turn on the host device.

    >>> replica_mesh(2, "cpu")
    [device(type='cpu'), device(type='cpu')]
    >>> replica_mesh(0, "cpu")  # doctest: +IGNORE_EXCEPTION_DETAIL
    Traceback (most recent call last):
    ValueError: ...
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n_shards
    if n_shards == 1:
        return [device]
    visible = torch.cuda.device_count()
    if visible < n_shards:
        raise ValueError(
            f"replica mesh needs {n_shards} CUDA devices, one a shard, but "
            f"only {visible} are visible (torch.cuda.device_count()); "
            "lower engine_shards or run on a host with more cards")
    return [torch.device("cuda", s) for s in range(n_shards)]


def shard_seeds(seed: int, n_shards: int) -> List[int]:
    """One run seed a shard, for an ``n_shards``-shard run seeded ``seed``.

    ``n_shards == 1`` returns ``[seed]``; otherwise shard ``s``'s seed is
    a 64-bit hash of ``(seed, s)``: the state of the ``s``-th child that
    ``np.random.SeedSequence(seed).spawn`` gives, whose spawn key keeps it
    apart from a chunk's seed (``core.vectorized._chunk_seed`` hashes
    ``[seed, i]`` with none) and from an unsharded run's; it does not
    depend on ``n_shards``.

    >>> shard_seeds(7, 1)
    [7]
    >>> len(set(shard_seeds(7, 4)))
    4
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n_shards == 1:
        return [seed]
    seeds = [int(child.generate_state(1, np.uint64)[0]) for child in
             np.random.SeedSequence(seed % (1 << 64)).spawn(n_shards)]
    if len(set(seeds)) != n_shards:      # a 64-bit collision
        raise RuntimeError(f"shard seeds of seed {seed} collide: {seeds}")
    return seeds


def replica_state_specs(state: Dict[str, object],
                        unbatched: Iterable[str] = (),
                        ) -> Dict[str, Optional[str]]:
    """The axis each lane of a ``(P, R, ...)`` state splits over:
    :data:`REPLICA_AXIS` for a batched lane (its dimension 1), None for a
    lane named in ``unbatched`` (the shared bin edges), which every shard
    takes whole.

    >>> replica_state_specs({"t": None, "hist_edges": None},
    ...                     unbatched=("hist_edges",))
    {'t': 'r', 'hist_edges': None}
    """
    unbatched = set(unbatched)
    return {k: None if k in unbatched else REPLICA_AXIS for k in state}
