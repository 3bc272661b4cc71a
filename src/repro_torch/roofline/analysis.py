"""Roofline analysis of a traced mesh step, with the H100's constants.

Three terms per (arch x shape x mesh) cell, all in seconds, per rank:

    compute    = counted FLOPs / peak FLOP/s
    memory     = counted HBM bytes / HBM bandwidth
    collective = collective link bytes / link bandwidth

Counterpart of ``src/repro/roofline/analysis.py``.  The reference reads
its counts from XLA's compiled HLO.  The port has no HLO: ``launch.dryrun``
runs the eager step on fake tensors in a fake process group and counts
what it dispatches.

* FLOPs: :class:`torch.utils.flop_counter.FlopCounterMode`'s total, the
  matrix products, as the reference counts dot ops alone.
* HBM bytes: :class:`ByteCounter`, the operand + result bytes of every
  aten op, since in eager every op is a kernel of its own that reads its
  inputs from HBM and writes its outputs there.  The exceptions:

  - a view or other aliasing op (``view``, ``transpose``, ``expand``,
    ``detach``, ``_unsafe_view``...) and an allocation (``empty``) move
    nothing: 0;
  - an in-place scatter or copy (``copy_``, ``index_put_``, ``scatter_``,
    ``index_copy_``, ...) counts twice its source (read, then written in
    place), as the reference counts ``dynamic-update-slice``;
  - an index or gather op (``index``, ``index_select``, ``gather``,
    ``embedding``) counts twice its result plus its index, as the
    reference counts ``dynamic-slice``;
  - a collective, and the copies it makes of its operands, belong to the
    collective term (``parallel.comm`` suspends this count inside them).

* a loop of identical steps traced once (the plain scan's time loop in
  ``launch.dryrun``) counts its step's bytes ``n`` times inside
  :func:`repeated`, as the reference scales a while body by its trip
  count.
* collective bytes: ``parallel.comm``'s record of every collective the
  step issues (kind, result bytes, group size), under the reference's
  ring conventions (:func:`collective_bytes`).
* MODEL_FLOPS analytically (6 N_active tokens for training), giving the
  useful-compute ratio that catches remat and dispatch waste.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..parallel import comm

# ---- NVIDIA H100 SXM5 (the H100 data sheet, SXM5 column) -------------------
#: dense BF16 tensor-core peak: 1,979 TFLOP/s with sparsity, half without
PEAK_FLOPS = 989e12
#: FP32 on the CUDA cores (67 TFLOP/s)
FP32_FLOPS = 67e12
#: HBM3 bandwidth: 3.35 TB/s
HBM_BW = 3.35e12
#: HBM3 capacity: 80 GB
HBM_PER_CHIP = 80e9
#: one 400 Gb/s ConnectX-7 NDR port a GPU, eight to a DGX H100 node.  The
#: 16-wide "model" axis of the production meshes spans two 8-GPU nodes and
#: the other axes span nodes, so this is every ring's bottleneck link.
#: NVLink (900 GB/s a GPU, 450 GB/s a direction) is the link within a node,
#: which the three-term model does not use.
LINK_BW = 50e9
#: special-function results (exp2, log2, rcp) a second: 16 a clock on each
#: of the 132 SMs (the CUDA C++ Programming Guide's throughput table for
#: compute capability 9.0) at the 1.98 GHz maximum SM clock
#: (nvidia-smi clocks.max.sm)
SFU_OPS_PER_S = 132 * 16 * 1.98e9
#: streaming multiprocessors of the SXM5 card
N_SM = 132


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, nbytes: int, repeats: int = 1) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) \
            + nbytes * repeats
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + repeats


def collective_bytes(records: Iterable) -> CollectiveStats:
    """Sum per-device collective link bytes over ``records`` (each with
    ``kind``, ``nbytes`` -- the result's bytes on this rank -- and
    ``group_size``: ``parallel.comm.Collective``).

    Convention (bytes crossing the bottleneck link per device, ring
    algorithms over a group of size g), the reference's:
      all-gather:         result_bytes * (g-1)/g
      reduce-scatter:     result_bytes * (g-1)        (operand = result*g)
      all-reduce:         2 * result_bytes * (g-1)/g
      all-to-all:         result_bytes * (g-1)/g
      collective-permute: result_bytes
    """
    stats = CollectiveStats()
    for rec in records:
        kind, nbytes, g = rec.kind, rec.nbytes, max(int(rec.group_size), 1)
        if kind == "all-gather":
            eff = nbytes * (g - 1) / g
        elif kind == "reduce-scatter":
            eff = nbytes * (g - 1)
        elif kind == "all-reduce":
            eff = 2 * nbytes * (g - 1) / g
        elif kind == "all-to-all":
            eff = nbytes * (g - 1) / g
        else:  # collective-permute
            eff = nbytes
        stats.add(kind, int(eff))
    return stats


# ---------------------------------------------------------------------------
# the byte counter
# ---------------------------------------------------------------------------

#: aliasing ops without a view annotation, and ops that move no data
_FREE = frozenset({"_unsafe_view", "lift_fresh", "alias", "detach",
                   "promote_types", "_local_scalar_dense", "empty",
                   "empty_like", "new_empty", "empty_strided",
                   "new_empty_strided", "sym_size", "sym_stride",
                   "sym_numel", "sym_storage_offset", "is_same_size"})
#: in-place scatters and copies: the position of their source argument
_SCATTER_SOURCE = {"copy_": 1, "index_put_": 2, "_index_put_impl_": 2,
                   "scatter_": 3, "scatter_add_": 3, "scatter_reduce_": 3,
                   "index_copy_": 3, "index_add_": 3, "masked_scatter_": 2}
#: index and gather ops
_GATHERS = frozenset({"index", "index_select", "gather", "embedding",
                      "take"})


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def op_bytes(func, args, kwargs, out) -> int:
    """HBM bytes one aten op moves, by the rules of this module's
    docstring."""
    name = func.overloadpacket.__name__
    ns = func.namespace
    if ns != "aten" or func.is_view or name in _FREE:
        return 0
    if name in _SCATTER_SOURCE:
        i = _SCATTER_SOURCE[name]
        src = args[i] if len(args) > i else None
        if not isinstance(src, torch.Tensor):      # scatter_.value
            idx = args[2] if len(args) > 2 else None
            return 2 * (idx.numel() * args[0].element_size()
                        if isinstance(idx, torch.Tensor) else 0)
        return 2 * _nbytes(src)
    if name in _GATHERS:
        index = sum(_nbytes(t) for t in _tensors((args[1:], kwargs))
                    if not (t.is_floating_point() or t.is_complex()))
        return 2 * sum(_nbytes(t) for t in _tensors(out)) + index
    return sum(_nbytes(t) for t in _tensors((args, kwargs))) \
        + sum(_nbytes(t) for t in _tensors(out))


_REPEAT: contextvars.ContextVar = contextvars.ContextVar("repeat",
                                                         default=1)


@contextlib.contextmanager
def repeated(n: int) -> Iterator[None]:
    """Count every op of the block ``n`` times (nested blocks multiply)."""
    token = _REPEAT.set(_REPEAT.get() * int(n))
    try:
        yield
    finally:
        _REPEAT.reset(token)


def repeats() -> int:
    """The current :func:`repeated` factor (1 outside any)."""
    return _REPEAT.get()


class ByteCounter(TorchDispatchMode):
    """Counts the HBM bytes of the aten ops dispatched inside it
    (:func:`op_bytes`, times :func:`repeats`), except inside a collective
    (``parallel.comm``).
    ``total`` is the sum; ``by_op`` maps each op to its bytes."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.by_op: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not comm.inside_collective():
            n = op_bytes(func, args, kwargs, out) * repeats()
            if n:
                self.total += n
                key = str(func)
                self.by_op[key] = self.by_op.get(key, 0) + n
        return out


# ---------------------------------------------------------------------------
# analytic model FLOPs / bytes (the denominator of the useful-compute ratio)
# ---------------------------------------------------------------------------

def _n_attn(cfg) -> int:
    return sum(1 for i in range(cfg.n_layers) if cfg.layer_kind(i) == "attn")


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS for the cell (6*N*D train, 2*N*D inference)."""
    n_active = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    tokens = B * S
    if shape.kind == "train":
        # causal attention: fwd 2*2*S^2/2*H*hd per example; train = 3x fwd
        attn = 3.0 * 2.0 * B * S * S * cfg.n_heads * cfg.head_dim \
            * _n_attn(cfg)
        return 6.0 * n_active * tokens + attn
    if shape.kind == "prefill":
        attn = 2.0 * B * S * S * cfg.n_heads * cfg.head_dim * _n_attn(cfg)
        return 2.0 * n_active * tokens + attn
    # decode: one token per request
    attn = 4.0 * B * S * cfg.n_heads * cfg.head_dim * _n_attn(cfg)
    return 2.0 * n_active * B + attn


def model_bytes(cfg, shape) -> float:
    """Analytic minimum HBM traffic (params/caches read once)."""
    p_bytes = cfg.active_param_count() * 2.0   # bf16
    if shape.kind == "train":
        return 3.0 * cfg.param_count() * 2.0   # params+grads+opt touched
    if shape.kind == "prefill":
        return p_bytes
    # decode: read params + full KV cache
    B, S = shape.global_batch, shape.seq_len
    kv = 2.0 * B * S * cfg.n_kv_heads * cfg.head_dim * 2.0 * _n_attn(cfg)
    return p_bytes + kv


# ---------------------------------------------------------------------------
# the three-term roofline
# ---------------------------------------------------------------------------

@dataclass
class Roofline:
    """All hlo_* / coll_* fields are PER-DEVICE per step (the names are the
    reference's: here they hold the traced step's counts); model_flops_
    is the cluster-wide analytic total."""
    arch: str
    shape: str
    mesh: str
    n_chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    model_flops_: float
    per_device_hbm: float
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0
    fits_hbm: bool = True
    collectives: Dict[str, int] = field(default_factory=dict)

    def finalize(self) -> "Roofline":
        self.compute_s = self.hlo_flops / PEAK_FLOPS
        self.memory_s = self.hlo_bytes / HBM_BW
        self.collective_s = self.coll_bytes / LINK_BW
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        total = self.hlo_flops * self.n_chips
        self.useful_ratio = self.model_flops_ / total if total else 0.0
        self.fits_hbm = self.per_device_hbm <= HBM_PER_CHIP
        return self

    @property
    def step_time_bound_s(self) -> float:
        """Lower bound on step time = max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """useful (model) compute time / achievable step-time bound."""
        useful_s = self.model_flops_ / (self.n_chips * PEAK_FLOPS)
        bound = self.step_time_bound_s
        return useful_s / bound if bound > 0 else 0.0

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["step_time_bound_s"] = self.step_time_bound_s
        d["roofline_fraction"] = self.roofline_fraction
        return d


def analyze(arch: str, shape_name: str, mesh_name: str, n_chips: int,
            cfg, shape, collectives: Iterable, flops: float,
            hbm_bytes: float, per_device_bytes: float) -> Roofline:
    """The cell's roofline from a traced step's per-device ``flops``,
    ``hbm_bytes`` and ``collectives`` (``parallel.comm``'s records), with
    the reference's floors: the counts cannot beat the analytic model math
    or the minimum traffic."""
    coll = collective_bytes(collectives)
    mf = model_flops(cfg, shape)                         # cluster total
    flops = max(float(flops), mf / n_chips)
    hbm_bytes = max(float(hbm_bytes), model_bytes(cfg, shape) / n_chips)
    r = Roofline(arch=arch, shape=shape_name, mesh=mesh_name,
                 n_chips=n_chips, hlo_flops=flops, hlo_bytes=hbm_bytes,
                 coll_bytes=float(coll.total_bytes), model_flops_=mf,
                 per_device_hbm=per_device_bytes,
                 collectives=dict(coll.bytes_by_kind))
    return r.finalize()
