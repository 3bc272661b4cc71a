"""Multi-pod dry run: trace every (architecture x input shape) on the
production meshes, without allocating a single model byte.

Counterpart of ``src/repro/launch/dryrun.py``.  The reference lowers and
compiles each cell for 512 host devices and reads XLA's analyses; the port
has no compiler in between, so it runs rank 0's step itself, eagerly, on
fake tensors (``torch._subclasses.FakeTensorMode``: shapes, dtypes and
devices, no storage) in a fake process group (``torch.distributed``'s
"fake" backend: every collective returns at once) of 256 or 512 ranks.
Nothing is allocated on any device and no card is needed: this is the
reference's host-device design, not a CPU fallback of a card path.

The plain selective scan is a Python loop over time, a few dozen ops a
step: at 32,768 positions and 64 layers that is hours of dispatch on
fake tensors.  Its steps are identical, so the trace runs one and counts
it as many times as the loop would (:class:`_LoopScan`), as the
reference scales a while body by its trip count.

For each cell this records, for rank 0:
  * argument, peak temporary and output bytes (proves it fits the 80 GB);
  * the matmul FLOPs and the HBM bytes of every op the step dispatches
    (``roofline.analysis``: FlopCounterMode and ByteCounter);
  * every collective the schedule issues (``parallel.comm``'s record);
  * the three roofline terms + bottleneck + useful-compute ratio.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch all --shape all --mesh single,multi \\
      --out results/torch/dryrun.json

``--mesh`` also takes a small mesh over ("data", "model") as ``AxB``
(``1x2``: two ranks), to read what a test or a card run of that size
issues.
"""

from __future__ import annotations

import argparse
import contextlib
import contextvars
import json
import math
import os
import time
import traceback
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCH_IDS, SHAPES, applicable, get_config
from ..kernels import ref
from ..models import build_model
from ..models.config import ModelConfig
from ..models.module import TensorSpec
from ..parallel import ParallelConfig, build_step, comm, sharding
from ..roofline.analysis import ByteCounter, analyze, repeated
from ..train.optimizer import OptimizerConfig
from .mesh import POD_AXES, make_mesh, production_shape


def opt_config_for(cfg: ModelConfig) -> OptimizerConfig:
    """fp32 Adam moments by default; bf16 for the >=100B monsters (the
    card's 80 GB HBM budget -- recorded in the fits-HBM column)."""
    big = cfg.param_count() > 100e9
    return OptimizerConfig(state_dtype="bfloat16" if big else "float32")


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0) -> Iterator[None]:
    """A fake process group of ``world_size`` ranks, as rank ``rank``, for
    the block: created when none is initialised and destroyed on exit; an
    initialised group of that size is used as it is."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise ValueError(f"a process group of {dist.get_world_size()} "
                             f"ranks is initialised; the dry run needs "
                             f"{world_size}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def local_parts(specs: Any, shardings: Any, mesh, device,
                make: Callable = torch.zeros) -> Any:
    """This rank's parts of a tree of :class:`TensorSpec` under
    ``shardings`` (``parallel.sharding``'s specs), each ``make(shape,
    dtype=, device=)`` (under a FakeTensorMode: fake tensors)."""
    if isinstance(specs, TensorSpec):
        shape = specs.shape
        if mesh.size > 1:
            idx = sharding.local_slice(shardings, shape, mesh, mesh.coords)
            shape = tuple(s.stop - s.start for s in idx)
        return make(shape, dtype=specs.dtype, device=device)
    if isinstance(specs, dict):
        return {k: local_parts(v, shardings[k], mesh, device, make)
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [local_parts(v, s, mesh, device, make)
                for v, s in zip(specs, shardings)]
    return specs


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

def _storages(tree) -> Dict[int, torch.UntypedStorage]:
    out = {}
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[id(st)] = st
    return out


_HELD: contextvars.ContextVar = contextvars.ContextVar("held", default=1)


@contextlib.contextmanager
def _held(n: int) -> Iterator[None]:
    """The storages made in the block stand for ``n`` alike."""
    token = _HELD.set(_HELD.get() * n)
    try:
        yield
    finally:
        _HELD.reset(token)


#: the CUDA caching allocator's block: an allocation takes a multiple of
#: 512 bytes (512 at least), which ``torch.cuda.memory_allocated`` counts
BLOCK = 512


def _blocks(nbytes: int) -> int:
    return -(-nbytes // BLOCK) * BLOCK


class LiveBytes(TorchDispatchMode):
    """Tracks the storages the ops inside it create, until each is freed:
    ``live`` bytes now and their ``peak``, each storage in whole
    allocator blocks (:data:`BLOCK`).  Storages of ``known`` (the
    arguments) and on the meta device (a module skeleton) are not
    counted; one made inside :func:`_held` counts as its factor's many."""

    def __init__(self, known: Dict[int, torch.UntypedStorage]):
        super().__init__()
        self.known = known
        self.seen: Dict[int, "weakref.ref"] = {}
        self.live = self.peak = 0

    def _free(self, key: int, nbytes: int) -> None:
        self.seen.pop(key, None)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor) or t.device.type == "meta":
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self.known or key in self.seen:
                continue
            nbytes = _blocks(st.nbytes()) * _HELD.get()
            self.seen[key] = weakref.ref(
                st, lambda _, k=key, n=nbytes: self._free(k, n))
            self.live += nbytes
            self.peak = max(self.peak, self.live)
        return out


@dataclass
class Trace:
    """One step's counts on this rank: matmul ``flops``, HBM ``nbytes``
    (``roofline.analysis``), the ``collectives`` in the order issued,
    argument / peak temporary / output bytes, the host seconds, the
    bytes by op and the step's outputs."""
    flops: int
    nbytes: int
    collectives: List[comm.Collective]
    arg_bytes: int
    temp_bytes: int
    output_bytes: int
    seconds: float
    by_op: Dict[str, int] = field(default_factory=dict, repr=False)
    outputs: Any = field(default=None, repr=False)


def trace_step(fn: Callable, args: Sequence[Any]) -> Trace:
    """Run ``fn(*args)`` once under the FLOP and byte counters, the
    live-storage tracker and the collective recorder (fake tensors or
    real ones alike)."""
    known = _storages(args)
    arg_bytes = sum(st.nbytes() for st in known.values())
    flop_mode, byte_mode, live = (FlopCounterMode(display=False),
                                  ByteCounter(), LiveBytes(known))
    t0 = time.perf_counter()
    with comm.recording() as record, flop_mode, byte_mode, live:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    out_st = _storages(out)
    output_bytes = sum(st.nbytes() for k, st in out_st.items()
                       if k not in known)
    return Trace(flops=flop_mode.get_total_flops(), nbytes=byte_mode.total,
                 collectives=list(record), arg_bytes=arg_bytes,
                 temp_bytes=live.peak, output_bytes=output_bytes,
                 seconds=seconds, by_op=byte_mode.by_op, outputs=out)


def step_args(step, shape, mesh, device="cpu",
              make: Callable = torch.zeros) -> List[Any]:
    """This rank's arguments of a built step: its parts of every input
    (``make``'s tensors), the decode position a Python int at the cache's
    last slot (every key attended)."""
    args = [local_parts(s, sh, mesh, device, make)
            for s, sh in zip(step.in_specs, step.in_shardings)]
    if shape.kind == "decode":
        args[3] = shape.seq_len - 1
    return args


def _keep(t):
    return t


class _LoopScan(torch.autograd.Function):
    """The plain scan's S identical time steps as the trace counts them:
    one step (``kernels.ref.selective_scan_step_ref``, as the loop calls
    it), its bytes counted S times and, under autograd, its storages held
    S times (the loop keeps every step's residuals); its backward, one
    step's, counted S times.  The step has no matmul, so the FLOPs are
    the loop's (none).  The eager loop's
    backward also adds up S full-size gradients of the inputs' per-step
    slices, O(S^2) bytes of the plain version alone, which this leaves
    out."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, h0):
        S = x.shape[1]
        grad = any(ctx.needs_input_grad)
        # the step's own graph keeps its tensors: a remat checkpoint
        # around the layer must not recompute it inside this backward
        with (torch.enable_grad() if grad else contextlib.nullcontext()), \
                torch.autograd.graph.saved_tensors_hooks(_keep, _keep):
            leaves = [t.detach().requires_grad_(need) for t, need in zip(
                (x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], h0),
                ctx.needs_input_grad)]
            with repeated(S), _held(S if grad else 1):
                y_t, h = ref.selective_scan_step_ref(
                    leaves[0].float(), *leaves[1:])
        y = torch.stack([y_t.detach()] * S, dim=1).to(x.dtype)
        if grad:
            ctx.step = (leaves, y_t, h)
        return y, h.detach()

    @staticmethod
    def backward(ctx, g_y, g_h):
        leaves, y_t, h = ctx.step
        S = g_y.shape[1]
        want = [i for i, t in enumerate(leaves) if t.requires_grad]
        with repeated(S):
            grads = torch.autograd.grad(
                (y_t, h), [leaves[i] for i in want],
                (g_y[:, 0].to(y_t.dtype), g_h), allow_unused=True)
        out = [None] * 6
        for i, g in zip(want, grads):
            if g is not None and i in (0, 1, 3, 4):   # a per-step slice
                g = g.unsqueeze(1).expand(g.shape[0], S, *g.shape[1:])
            out[i] = g
        return tuple(out)


def _loop_scan(x, dt, A, Bmat, Cmat, h0=None):
    if h0 is None:
        h0 = torch.zeros((x.shape[0], x.shape[2], A.shape[-1]),
                         dtype=torch.float32, device=x.device)
    if x.shape[1] < 2:
        return _plain_scan(x, dt, A, Bmat, Cmat, h0)
    return _LoopScan.apply(x, dt, A, Bmat, Cmat, h0)


_plain_scan = ref.selective_scan_ref


@contextlib.contextmanager
def _scan_as_one_step() -> Iterator[None]:
    """The plain scan counted as :class:`_LoopScan` for the block."""
    ref.selective_scan_ref = _loop_scan
    try:
        yield
    finally:
        ref.selective_scan_ref = _plain_scan


def trace_fake(step, shape, mesh, device="cpu") -> Trace:
    """:func:`trace_step` of ``step`` on fake tensors of this rank's
    parts (the plain scan counted as :class:`_LoopScan`)."""
    with FakeTensorMode(allow_non_fake_inputs=True), _scan_as_one_step():
        args = step_args(step, shape, mesh, device, torch.empty)
        return trace_step(step.fn, args)


def collective_summary(records: Sequence[comm.Collective]
                       ) -> Dict[str, Dict[str, int]]:
    """kind -> {"count", "bytes"} (the results' bytes on this rank)."""
    out: Dict[str, Dict[str, int]] = {}
    for r in records:
        d = out.setdefault(r.kind, {"count": 0, "bytes": 0})
        d["count"] += 1
        d["bytes"] += r.nbytes
    return out


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------

def mesh_name_of(mesh_kind: str) -> str:
    """"single" / "multi" -> the reference's mesh names; ``AxB`` as is."""
    return {"single": "16x16", "multi": "2x16x16"}.get(mesh_kind, mesh_kind)


def mesh_layout(mesh_name: str):
    """(sizes, axes) of a mesh name: the production meshes, or ``AxB``
    over ("data", "model")."""
    if mesh_name in ("16x16", "2x16x16"):
        return production_shape(multi_pod=mesh_name == "2x16x16")
    sizes = tuple(int(n) for n in mesh_name.split("x"))
    if len(sizes) != 2:
        raise ValueError(f"mesh {mesh_name!r}: give single, multi or AxB")
    return sizes, POD_AXES


def trace_rank(cfg: ModelConfig, shape, mesh_name: str,
               pcfg: Optional[ParallelConfig] = None,
               opt_cfg: Optional[OptimizerConfig] = None,
               rank: int = 0) -> Trace:
    """Rank ``rank``'s step of ``cfg`` x ``shape`` (``impl="ref"``) on the
    mesh ``mesh_name``, traced on fake tensors in a fake world."""
    sizes, axes = mesh_layout(mesh_name)
    with fake_world(math.prod(sizes), rank):
        mesh = make_mesh(sizes, axes, device="cpu")
        bundle = build_model(cfg, device="cpu")
        step = build_step(bundle, mesh, shape,
                          opt_cfg=opt_cfg or opt_config_for(cfg), pcfg=pcfg,
                          impl="ref")
        return trace_fake(step, shape, mesh)


def trace_cell(cfg: ModelConfig, shape, mesh_name: str,
               pcfg: Optional[ParallelConfig] = None,
               opt_cfg: Optional[OptimizerConfig] = None):
    """Rank 0's traced step of ``cfg`` x ``shape`` on the mesh
    ``mesh_name``: the record's counted fields and the roofline (raises
    on any failure)."""
    tr = trace_rank(cfg, shape, mesh_name, pcfg, opt_cfg)
    n_chips = math.prod(mesh_layout(mesh_name)[0])
    # the arguments are donated (updated in place), so args + peak
    # temporaries is the resident footprint
    resident = float(tr.arg_bytes + tr.temp_bytes)
    roof = analyze(cfg.name, shape.name, mesh_name, n_chips, cfg, shape,
                   tr.collectives, tr.flops, tr.nbytes, resident)
    return {"n_chips": n_chips, "trace_s": round(tr.seconds, 1),
            "arg_bytes": int(tr.arg_bytes), "temp_bytes": int(tr.temp_bytes),
            "output_bytes": int(tr.output_bytes),
            "per_device_resident_gb": round(resident / 1e9, 3),
            "counted_flops": float(tr.flops),
            "counted_bytes": float(tr.nbytes),
            "collectives": collective_summary(tr.collectives),
            "roofline": roof.to_dict()}, roof


def run_cell(arch: str, shape_name: str, multi_pod, pcfg=None,
             verbose: bool = True) -> Dict:
    """One cell's record: ``multi_pod`` False / True for the production
    meshes (16x16 / 2x16x16), or a mesh name (``"1x2"``)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = (multi_pod if isinstance(multi_pod, str)
                 else "2x16x16" if multi_pod else "16x16")
    ok, reason = applicable(cfg, shape)
    record: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if not ok:
        record["status"] = "SKIP"
        record["reason"] = reason
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: SKIP "
                  f"({reason.split(';')[0]})")
        return record
    try:
        fields, _ = trace_cell(cfg, shape, mesh_name, pcfg)
    except Exception as exc:  # a failure here is a bug in the system
        record["status"] = "FAIL"
        record["error"] = f"{type(exc).__name__}: {exc}"
        record["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: FAIL "
                  f"{record['error']}")
        return record
    record["status"] = "OK"
    record.update(fields)
    if verbose:
        r = record["roofline"]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
              f"trace={record['trace_s']:.0f}s resident/dev="
              f"{record['per_device_resident_gb']:.2f}GB "
              f"bottleneck={r['bottleneck']} "
              f"terms(c/m/x)={r['compute_s']:.4f}/{r['memory_s']:.4f}/"
              f"{r['collective_s']:.4f}s frac={r['roofline_fraction']:.2f}")
    return record


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all", help="comma list or 'all'")
    ap.add_argument("--shape", default="all", help="comma list or 'all'")
    ap.add_argument("--mesh", default="single,multi",
                    help="single | multi | single,multi (or AxB)")
    ap.add_argument("--out", default="results/torch/dryrun.json")
    ap.add_argument("--append", action="store_true",
                    help="merge with existing --out file")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = [mesh_name_of(m.strip()) for m in args.mesh.split(",")]

    records: List[Dict] = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            records = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in records
            if r.get("status") == "OK"}

    for arch in archs:
        for shape_name in shapes:
            for mesh_name in meshes:
                key = (arch, shape_name, mesh_name)
                if key in done:
                    continue
                rec = run_cell(arch, shape_name, mesh_name)
                records = [r for r in records
                           if (r["arch"], r["shape"], r["mesh"]) != key]
                records.append(rec)
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "w") as f:
                    json.dump(records, f, indent=1)

    n_ok = sum(1 for r in records if r["status"] == "OK")
    n_skip = sum(1 for r in records if r["status"] == "SKIP")
    n_fail = sum(1 for r in records if r["status"] == "FAIL")
    print(f"[dryrun] done: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL "
          f"-> {args.out}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
