"""Hopper CUDA kernel that runs a chunk of CTMC steps in one launch.

Counterpart, on the single-job path, of the Pallas TPU kernel
``src/repro/kernels/des_step.py::_event_race_kernel`` together with the
``lax.scan`` of ``src/repro/core/vectorized.py::_chunk_loop`` around it,
for every failure family of :data:`KINDS` and repair family of
:data:`REPAIR_KINDS`: one instance a failure family for exponential
repairs (a thread a row), one slot instance a failure family for the
other repair families (a warp a row, the row's repair-slot lane in shared
memory; :func:`slot_plan`), and one scenario instance a failure family for
a fault-domain scenario with exponential repairs (a thread a row, D shock
lanes after the 16 in the race, the campaign residual first).  Each of
those fifteen instances has a float64 twin for ``Params.age_dtype=
"float64"`` (the ``age`` lane, and ``repair_rem`` with it, in float64),
built from the same source into a library of its own (:data:`LIBRARY64`).
Each instance also has a wide twin (:data:`LIBRARY_WIDE`,
:data:`LIBRARY_WIDE64`) for the shapes past the standard instances' caps:
more than :data:`MAX_SEGMENTS` empirical segments, histogram edges or a
slot lane that one block's shared memory cannot hold (:func:`wide_for`
says which a state needs; the engine routes by it before launch).
The kernel lives in ``repro_torch/csrc/ctmc_chunk.cu`` (what it computes,
its bound and its design are noted there); :mod:`._build` builds it with
``nvcc -fmad=false`` on first use and binds it with ``ctypes``, and
:func:`ctmc_chunk_cuda` launches it on PyTorch's current stream.

The state is the engine's dict of tensors.  The kernel knows exactly the
lanes of the single-job step: :func:`chunk_layout` refuses any other key
and any lane dtype or shape but that path's, so a lane that a later
engine adds cannot be dropped without notice.

``LAUNCHES`` counts kernel launches, ``LAUNCHES_BY_KIND`` the same by
failure family, ``LAUNCHES_BY_REPAIR`` by repair family,
``LAUNCHES_BY_SCEN`` the scenario instances' by failure family,
``LAUNCHES_BY_AGE`` by the age lane's dtype, ``LAUNCHES_WIDE`` the wide
instances' among them and ``STEPS`` the steps they ran, so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence

import torch

from ._build import CudaLibrary, check_launch

#: failure families the kernel runs, in its instance order (the ``Kind``
#: codes of ``csrc/ctmc_chunk.cu``; ``core.hazards.HAZARD_KINDS``)
KINDS = ("exponential", "weibull", "bathtub", "lognormal", "empirical")
#: repair families the kernel runs, in its ``RepairKind`` order
#: (``core.hazards.REPAIR_KINDS``); all but the first run a slot instance
REPAIR_KINDS = ("exponential", "weibull", "lognormal", "deterministic",
                "empirical")
#: empirical segments a clock the standard instances take
#: (``kMaxSegments``); the wide instances take any count from 2
MAX_SEGMENTS = 64

#: launches of the chunk kernel since import (or the last reset)
LAUNCHES = 0
#: the same launches by failure family
LAUNCHES_BY_KIND = dict.fromkeys(KINDS, 0)
#: the same launches by repair family
LAUNCHES_BY_REPAIR = dict.fromkeys(REPAIR_KINDS, 0)
#: the scenario instances' launches by failure family
LAUNCHES_BY_SCEN = dict.fromkeys(KINDS, 0)
#: the age lane's dtypes, in the order of the two libraries
AGE_DTYPES = ("float32", "float64")
#: the same launches by the age lane's dtype
LAUNCHES_BY_AGE = dict.fromkeys(AGE_DTYPES, 0)
#: the wide instances' launches among them
LAUNCHES_WIDE = 0
#: steps those launches ran
STEPS = 0

#: (B, 4) pool compartments, in the kernel's slot order
COMPARTMENTS = ("run", "sb", "fw", "fs", "auto", "man")
#: (B,) lanes, in the kernel's slot order: float32, but for ``age``, which
#: is float32 or float64 (the launch's age dtype)
LANES = ("t", "work_left", "timer", "stall_start", "age", "cur_run",
         "ckpt_work", "in_ckpt")
#: (B,) float32 metrics the step writes, in the kernel's slot order
METRICS = ("total_time", "n_failures", "n_random_failures",
           "n_systematic_failures", "n_preemptions", "n_auto_repairs",
           "n_manual_repairs", "n_failed_repairs", "n_host_selections",
           "n_standby_swaps", "n_undiagnosed", "n_misdiagnosed",
           "stall_time", "recovery_overhead", "lost_work", "useful_work",
           "checkpoint_overhead")
#: (B,) int32 lanes
INT_LANES = ("phase", "n_runs")
#: (B,) float32 metrics the step leaves as they are (the slot instances
#: write the first, the scenario instances the other three), so they pass
#: through untouched
CARRIED = ("n_repair_overflow", "n_domain_shocks", "n_shock_killed",
           "n_campaign_events")
#: histogram channels by kernel code (``core.histograms.HIST_CHANNELS``)
CHANNELS = ("run_duration", "recovery", "waiting", "goodput")

#: every lane the kernel writes (cloned unless the caller owns the state)
WRITTEN = COMPARTMENTS + LANES + METRICS + INT_LANES + ("run_durations",
                                                       "hist")
_KNOWN = frozenset(WRITTEN + CARRIED + ("hist_edges",))
#: the repair-slot lane of a non-exponential repair family, (B, n_slots):
#: remaining time in the age lane's dtype, class and stage int32
SLOT_LANES = ("repair_rem", "repair_cls", "repair_stage")
#: what a slot instance writes besides WRITTEN
SLOT_WRITTEN = SLOT_LANES + ("n_repair_overflow",)
#: a fault-domain scenario's lanes: the deficit (B,) float32, the shock
#: counts (B, D) float32, the schedule pointer (B,) int32 and the window
#: flag (B,) float32, each present as the scenario key calls for it
#: (:func:`scenario_lanes`)
SCEN_LANES = ("deficit", "domain_shocks", "camp_idx", "maint")
#: the counters a scenario instance writes, in its slot order
SCEN_METRICS = ("n_domain_shocks", "n_shock_killed", "n_campaign_events")
#: the schedule codes (``core.faultdomains``): KILL, MAINT_START, MAINT_END
_CODES = (0, 1, 2)
_N_PARAMS = 16
#: columns of the hazard block of the closed-form families, and of the
#: repair block of exponential repairs (``core.hazards``)
_N_HAZARD_COLS, _N_REPAIR_COLS = 5, 3
_MAX_SHARED = 227 * 1024


def pv_width(kind: str, n_seg: int = 0, rkind: str = "exponential",
             n_rseg: int = 0, n_dom: int = 0, n_camp: int = 0) -> int:
    """Parameter columns of one row for these families: the 16 base
    columns, the failure family's hazard block, the repair family's block
    and a scenario's ``2 n_dom + 3 n_camp`` columns.

    >>> pv_width("exponential"), pv_width("empirical", 3)
    (24, 29)
    >>> pv_width("exponential", 0, "empirical", 2)
    27
    >>> pv_width("exponential", n_dom=45, n_camp=3)
    123
    """
    hazard = 4 * n_seg - 2 if kind == "empirical" else _N_HAZARD_COLS
    repair = 4 * n_rseg - 2 if rkind == "empirical" else _N_REPAIR_COLS
    return _N_PARAMS + hazard + repair + 2 * n_dom + 3 * n_camp


def scenario_lanes(scen) -> tuple:
    """The lanes of :data:`SCEN_LANES` that the scenario key ``(D,
    codes)`` calls for: the deficit always, the shock counts for D > 0,
    the schedule pointer for a non-empty schedule, the window flag for a
    schedule with a maintenance start.

    >>> scenario_lanes((45, (0, 1, 2)))
    ('deficit', 'domain_shocks', 'camp_idx', 'maint')
    >>> scenario_lanes((0, (0,)))
    ('deficit', 'camp_idx')
    """
    n_dom, codes = scen
    return tuple(k for k, on in zip(SCEN_LANES, (
        True, n_dom > 0, len(codes) > 0, 1 in codes)) if on)


def n_uniforms(kind: str, rkind: str = "exponential") -> int:
    """Uniforms a step: 8, one more (u_haz) for a non-exponential failure
    family, one more (u_dur) for a non-exponential repair family."""
    return 8 + (kind != "exponential") + (rkind != "exponential")


def slot_plan(n_slots: int, n_edges: int = 0, age_bytes: int = 4) -> dict:
    """A slot instance's launch for a lane of ``n_slots`` slots a row and
    ``n_edges`` histogram edges: a block is one row, a warp (the register
    file, not shared memory, bounds how many rows an SM holds, and
    one-warp blocks fill it to that bound), with ``smem_bytes`` of
    dynamic shared memory (the edges, padded to 16 bytes, then a slot's
    remaining time, ``age_bytes`` = 4 or 8 for the float64 twins, and its
    4-byte class and stage).  Raises ``ValueError`` for a lane whose
    block would not fit an H100 block's shared memory, naming
    ``Params.repair_slots``.

    >>> slot_plan(128, 130)
    {'threads': 32, 'smem_bytes': 1552}
    >>> slot_plan(128, 130, age_bytes=8)
    {'threads': 32, 'smem_bytes': 2064}
    >>> slot_plan(4360, 130)["smem_bytes"]
    35408
    """
    if n_slots < 1:
        _fail(f"a slot lane of {n_slots} slots")
    edge_floats = -(-n_edges // 4) * 4
    slot_bytes = age_bytes + 4
    smem = _slot_smem(n_slots, n_edges, age_bytes)
    if smem > _MAX_SHARED:
        _fail(f"a repair-slot lane of {n_slots} slots a row needs {smem} "
              f"bytes of shared memory a block, over the {_MAX_SHARED} an "
              "H100 block takes; lower Params.repair_slots (or its "
              "auto-sized width) to at most "
              f"{(_MAX_SHARED - 4 * edge_floats) // slot_bytes}")
    return {"threads": 32, "smem_bytes": smem}


def _slot_smem(n_slots: int, n_edges: int, age_bytes: int) -> int:
    return 4 * (-(-n_edges // 4) * 4) + (age_bytes + 4) * n_slots


def wide_for(state: Dict[str, torch.Tensor], n_seg: int = 0,
             n_rseg: int = 0) -> bool:
    """Whether a chunk of ``state`` runs a wide instance: True where the
    standard instances refuse its shape and the wide ones take it -- more
    than :data:`MAX_SEGMENTS` empirical failure (``n_seg``) or repair
    (``n_rseg``) segments, more histogram edges than one block's shared
    memory holds, or a repair-slot lane :func:`slot_plan` refuses.  Reads
    shapes only, so the engine decides before it launches.

    >>> z = torch.zeros(2)
    >>> wide_for({"age": z}, 64), wide_for({"age": z}, 65)
    (False, True)
    >>> rem = torch.zeros((2, 32768))
    >>> wide_for({"age": z, "repair_rem": rem})
    True
    >>> wide_for({"age": z, "hist": z, "hist_edges": torch.zeros(65536)})
    True
    """
    if n_seg > MAX_SEGMENTS or n_rseg > MAX_SEGMENTS:
        return True
    n_edges = state["hist_edges"].shape[0] if "hist" in state else 0
    if n_edges * 4 > _MAX_SHARED:
        return True
    rem = state.get("repair_rem")
    return rem is not None and _slot_smem(
        rem.shape[-1], n_edges, state["age"].element_size()) > _MAX_SHARED


class ChunkArgs(ctypes.Structure):
    """``CtmcChunkArgs`` of ``csrc/ctmc_chunk.cu``, field for field."""
    _fields_ = [("comp", ctypes.c_void_p * len(COMPARTMENTS)),
                ("lane", ctypes.c_void_p * len(LANES)),
                ("metric", ctypes.c_void_p * len(METRICS)),
                ("phase", ctypes.c_void_p), ("n_runs", ctypes.c_void_p),
                ("run_durations", ctypes.c_void_p),
                ("hist", ctypes.c_void_p), ("hist_edges", ctypes.c_void_p),
                ("pv", ctypes.c_void_p), ("us", ctypes.c_void_p),
                ("pv_stride", ctypes.c_int64), ("n_rows", ctypes.c_int64),
                ("R", ctypes.c_int64), ("R_draw", ctypes.c_int64),
                ("n_steps", ctypes.c_int32), ("max_runs", ctypes.c_int32),
                ("n_sel", ctypes.c_int32), ("n_edges", ctypes.c_int32),
                ("chan", ctypes.c_int32 * 4), ("kind", ctypes.c_int32),
                ("n_seg", ctypes.c_int32),
                ("repair_rem", ctypes.c_void_p),
                ("repair_cls", ctypes.c_void_p),
                ("repair_stage", ctypes.c_void_p),
                ("n_repair_overflow", ctypes.c_void_p),
                ("rkind", ctypes.c_int32), ("n_rseg", ctypes.c_int32),
                ("n_slots", ctypes.c_int32),
                ("deficit", ctypes.c_void_p),
                ("domain_shocks", ctypes.c_void_p),
                ("camp_idx", ctypes.c_void_p), ("maint", ctypes.c_void_p),
                ("scen_metric", ctypes.c_void_p * len(SCEN_METRICS)),
                ("camp_codes", ctypes.c_void_p), ("n_dom", ctypes.c_int32),
                ("n_camp", ctypes.c_int32), ("scen", ctypes.c_int32)]


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.ctmc_chunk_launch
    fn.argtypes = [ctypes.POINTER(ChunkArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("ctmc_chunk", _bind, extra_flags=("-fmad=false",))
#: the float64 twins of every instance, from the same source
LIBRARY64 = CudaLibrary("ctmc_chunk_age64", _bind,
                        extra_flags=("-fmad=false", "-DCTMC_AGE_T=double"),
                        source="ctmc_chunk")
#: the wide twins of every instance (``kWideBit``), float32 and float64 age
LIBRARY_WIDE = CudaLibrary("ctmc_chunk_wide", _bind,
                           extra_flags=("-fmad=false", "-DCTMC_WIDE"),
                           source="ctmc_chunk")
LIBRARY_WIDE64 = CudaLibrary("ctmc_chunk_wide64", _bind,
                             extra_flags=("-fmad=false",
                                          "-DCTMC_AGE_T=double",
                                          "-DCTMC_WIDE"),
                             source="ctmc_chunk")


def _fail(msg: str) -> None:
    raise ValueError(f"ctmc_chunk: {msg}")


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> None:
    if t.dtype != dtype:
        _fail(f"{name} has dtype {t.dtype}; the kernel's is {dtype}")
    if tuple(t.shape) != shape:
        _fail(f"{name} has shape {tuple(t.shape)}, not {shape}")
    if t.device != device:
        _fail(f"{name} is on {t.device}, phase on {device}")
    if not t.is_contiguous():
        _fail(f"{name} is not contiguous (strides {t.stride()})")


def chunk_layout(state: Dict[str, torch.Tensor], us: torch.Tensor,
                 pv: torch.Tensor, R: int, P: int,
                 hist_channels: Sequence[str], *, kind: str = "exponential",
                 n_seg: int = 0, rkind: str = "exponential",
                 n_rseg: int = 0, scen=None, wide: bool = False) -> dict:
    """The launch's layout, after every check the kernel needs.

    ``state`` is the engine's state dict over ``B = P * R`` rows, ``us``
    one chunk's ``(n_steps, R_draw, n_uniforms(kind, rkind))`` float32
    draw with ``R_draw >= R``, ``pv`` one shared parameter row or a ``(B,
    pv_width(kind, n_seg, rkind, n_rseg))`` matrix, ``hist_channels`` the
    channels ``state["hist"]`` carries, ``kind`` / ``rkind`` the failure
    and repair families and ``n_seg`` / ``n_rseg`` their empirical segment
    counts (0 for the other families).  A non-exponential repair family
    needs the state's repair-slot lane (:data:`SLOT_LANES`), which an
    exponential one must not have.  ``scen`` is a fault-domain scenario's
    key ``(D, codes)`` (``core.faultdomains.scenario_key``), or None: a
    scenario launch runs the scenario instance, takes exponential repairs
    only, needs exactly the lanes :func:`scenario_lanes` names and the
    parameter row's ``2D + 3L`` trailing columns, and a launch without one
    refuses those lanes.  ``age`` is float32, or float64 for the float64
    twins, and a slot lane's ``repair_rem`` takes ``age``'s dtype: a mixed
    pair raises, naming ``repair_rem``.  Returns a dict: ``pointers`` (lane
    name -> data pointer), ``pv_stride`` (0 for a shared row), ``n_rows``,
    ``R``, ``P``, ``R_draw``, ``n_steps``, ``max_runs``, ``n_sel``,
    ``n_edges``, ``chan`` (the kernel's code of each carried channel, its
    index in :data:`CHANNELS`), ``kind`` and ``rkind`` (the families'
    codes, their indices in :data:`KINDS` and :data:`REPAIR_KINDS`),
    ``n_seg``, ``n_rseg``, ``n_slots`` (0 for exponential repairs),
    ``plan`` (:func:`slot_plan`'s, or None), ``scen`` (whether the
    scenario instance runs), ``n_dom``, ``n_camp``, ``codes`` (the
    schedule codes), ``age64`` (whether the float64 twin runs) and ``wide``.
    ``wide=True`` lays out a wide instance's launch: it takes any segment
    count from 2 and any number of edges and slots, and stages nothing in
    shared memory (its ``plan`` has ``smem_bytes`` 0).
    Raises ``ValueError`` on a family, segment count or scenario the
    kernel does not run, a key it does not know or lacks, a
    dtype, shape, device, stride or alignment it does not take, or a slot
    lane too wide for shared memory.  Works on tensors of any device.
    """
    if kind not in KINDS:
        _fail(f"failure family {kind!r} is not one of {KINDS}")
    max_seg = 2 ** 31 - 1 if wide else MAX_SEGMENTS
    if kind == "empirical" and not 2 <= n_seg <= max_seg:
        _fail(f"{n_seg} empirical segments; the kernel takes 2.."
              f"{MAX_SEGMENTS} a clock")
    if kind != "empirical" and n_seg != 0:
        _fail(f"n_seg={n_seg} for the {kind} family (segments are the "
              "empirical family's)")
    if rkind not in REPAIR_KINDS:
        _fail(f"repair family {rkind!r} is not one of {REPAIR_KINDS}")
    if rkind == "empirical" and not 2 <= n_rseg <= max_seg:
        _fail(f"{n_rseg} empirical repair segments; the kernel takes 2.."
              f"{MAX_SEGMENTS} a stage")
    if rkind != "empirical" and n_rseg != 0:
        _fail(f"n_rseg={n_rseg} for {rkind} repairs (segments are the "
              "empirical family's)")
    slotted = rkind != "exponential"
    slots = sorted(set(state) & set(SLOT_LANES))
    if slots and not slotted:
        _fail(f"state keys {slots} are the repair-slot lane of a "
              "non-exponential repair family, and the launch's repairs "
              "are exponential")
    n_dom, codes = 0, ()
    if scen is not None:
        n_dom, codes = scen
        codes = tuple(codes)
        if not isinstance(n_dom, int) or n_dom < 0 \
                or any(c not in _CODES for c in codes):
            _fail(f"scenario key {scen!r} is not (D >= 0, codes in "
                  f"{_CODES})")
        if slotted:
            _fail(f"a fault-domain scenario runs with exponential repairs, "
                  f"not {rkind} (the reference's CTMC engine sends such a "
                  "study to the event engine)")
    scen_keys = scenario_lanes(scen) if scen is not None else ()
    scen_lanes = sorted(set(state) & set(SCEN_LANES))
    if scen_lanes and scen is None:
        _fail(f"state keys {scen_lanes} are the lanes of a fault-domain "
              "scenario, and the launch has none")
    known = _KNOWN | (set(SLOT_LANES) if slotted else set()) | set(scen_keys)
    unknown = sorted(set(state) - known)
    if unknown:
        _fail(f"state keys {unknown} are lanes the kernel does not carry "
              "(it runs the single-job step)")
    has_hist = "hist" in state
    needed = set(known) - ({"hist", "hist_edges"} if not has_hist else set())
    missing = sorted(needed - set(state))
    if missing:
        _fail(f"state lacks {missing}")
    phase = state["phase"]
    device = phase.device
    B = phase.shape[0] if phase.ndim == 1 else -1
    if B != P * R or R < 1:
        _fail(f"phase {tuple(phase.shape)} is not (P * R,) = ({P} * {R},)")
    f32 = torch.float32
    age_dtype = state["age"].dtype
    if age_dtype not in (torch.float32, torch.float64):
        _fail(f"age has dtype {age_dtype}; the kernel's is torch.float32 "
              "or torch.float64")
    for k in COMPARTMENTS:
        _check(k, state[k], (B, 4), f32, device)
    for k in LANES + METRICS + CARRIED:
        _check(k, state[k], (B,), age_dtype if k == "age" else f32, device)
    for k in INT_LANES:
        _check(k, state[k], (B,), torch.int32, device)
    for k in scen_keys:
        shape = (B, n_dom) if k == "domain_shocks" else (B,)
        _check(k, state[k], shape,
               torch.int32 if k == "camp_idx" else f32, device)
    n_slots = 0
    if slotted:
        rem = state["repair_rem"]
        n_slots = rem.shape[1] if rem.ndim == 2 else -1
        # the slot lane's remaining times take the age lane's dtype
        _check("repair_rem", rem, (B, n_slots), age_dtype, device)
        for k in ("repair_cls", "repair_stage"):
            _check(k, state[k], (B, n_slots), torch.int32, device)
    ring = state["run_durations"]
    max_runs = ring.shape[1] if ring.ndim == 2 else -1
    _check("run_durations", ring, (B, max_runs), f32, device)
    n_sel = n_edges = 0
    chan = [0, 0, 0, 0]
    if has_hist:
        edges = state["hist_edges"]
        n_edges = edges.shape[0] if edges.ndim == 1 else 0
        _check("hist_edges", edges, (n_edges,), f32, device)
        if n_edges < 1 or (n_edges * 4 > _MAX_SHARED and not wide):
            _fail(f"{n_edges} histogram edges; the kernel stages 1.."
                  f"{_MAX_SHARED // 4} in shared memory")
        hist_channels = tuple(hist_channels)
        n_sel = len(hist_channels)
        if not 1 <= n_sel <= 4 or any(c not in CHANNELS
                                      for c in hist_channels):
            _fail(f"histogram channels {hist_channels} are not 1-4 of "
                  f"{CHANNELS}")
        _check("hist", state["hist"], (B, n_sel, n_edges + 1), f32, device)
        for i, c in enumerate(hist_channels):
            chan[i] = CHANNELS.index(c)
    age64 = age_dtype == torch.float64
    if not slotted:
        plan = None
    elif wide:
        plan = {"threads": 32, "smem_bytes": 0}
    else:
        plan = slot_plan(n_slots, n_edges, 8 if age64 else 4)
    n_u = n_uniforms(kind, rkind)
    if us.ndim != 3 or us.shape[2] != n_u or us.shape[1] < R:
        _fail(f"uniforms {tuple(us.shape)} are not (n_steps, R_draw >= "
              f"{R}, {n_u}) for {kind} failures and {rkind} repairs")
    _check("uniforms", us, tuple(us.shape), f32, device)
    if us.shape[0] >= 2 ** 31:
        _fail(f"{us.shape[0]} steps in one launch")
    if pv.ndim == 1:
        _check("pv", pv, tuple(pv.shape), f32, device)
        pv_stride = 0
    elif pv.ndim == 2 and pv.shape[0] == B:
        if pv.dtype != f32 or pv.device != device or (pv.shape[1] > 1
                                                     and pv.stride(1) != 1):
            _fail(f"pv {pv.dtype} on {pv.device} with strides {pv.stride()}"
                  " is not float32 rows on the state's device")
        pv_stride = pv.stride(0)
    else:
        _fail(f"pv {tuple(pv.shape)} is neither one row nor (B={B}, n_cols)")
    width = pv_width(kind, n_seg, rkind, n_rseg, n_dom, len(codes))
    if pv.shape[-1] != width:
        _fail(f"pv has {pv.shape[-1]} columns; the step of {kind} failures "
              f"and {rkind} repairs"
              + (f" under a scenario of {n_dom} domains and {len(codes)} "
                 "entries" if scen is not None else "")
              + f" reads {width}")
    pointers = {k: v.data_ptr() for k, v in state.items()}
    pointers.update(pv=pv.data_ptr(), us=us.data_ptr())
    # the exponential instance loads its 8-float uniform rows as float4
    for k in COMPARTMENTS + (("us",) if n_u == 8 else ()):
        if pointers[k] % 16:
            _fail(f"{k} is not 16-byte aligned (the kernel loads it as "
                  "float4)")
    return {"pointers": pointers, "pv_stride": pv_stride, "n_rows": B,
            "R": R, "P": P, "R_draw": us.shape[1], "n_steps": us.shape[0],
            "max_runs": max_runs, "n_sel": n_sel, "n_edges": n_edges,
            "chan": tuple(chan), "kind": KINDS.index(kind), "n_seg": n_seg,
            "rkind": REPAIR_KINDS.index(rkind), "n_rseg": n_rseg,
            "n_slots": n_slots, "plan": plan, "scen": scen is not None,
            "n_dom": n_dom, "n_camp": len(codes), "codes": codes,
            "age64": age64, "wide": wide}


def _args(layout: dict, codes=None) -> ChunkArgs:
    """The launch's struct; ``codes`` is the schedule codes as an int32
    tensor on the state's device (a scenario with a schedule only)."""
    ptr = layout["pointers"]
    args = ChunkArgs()
    args.comp[:] = [ptr[k] for k in COMPARTMENTS]
    args.lane[:] = [ptr[k] for k in LANES]
    args.metric[:] = [ptr[k] for k in METRICS]
    args.phase, args.n_runs = ptr["phase"], ptr["n_runs"]
    args.run_durations = ptr["run_durations"] if layout["max_runs"] else None
    args.hist = ptr.get("hist")
    args.hist_edges = ptr.get("hist_edges")
    args.pv, args.us = ptr["pv"], ptr["us"]
    for k in ("pv_stride", "n_rows", "R", "R_draw", "n_steps", "max_runs",
              "n_sel", "n_edges", "kind", "n_seg", "rkind", "n_rseg",
              "n_slots"):
        setattr(args, k, layout[k])
    args.chan[:] = list(layout["chan"])
    if layout["plan"] is not None:
        for k in SLOT_WRITTEN:
            setattr(args, k, ptr[k])
    if layout["scen"]:
        args.scen, args.n_dom = 1, layout["n_dom"]
        args.n_camp = layout["n_camp"]
        for k in SCEN_LANES:
            setattr(args, k, ptr.get(k))
        args.scen_metric[:] = [ptr[k] for k in SCEN_METRICS]
        if layout["n_camp"]:
            args.camp_codes = codes.data_ptr()
    return args


@functools.lru_cache(maxsize=None)
def schedule_codes(codes: tuple, device: torch.device) -> torch.Tensor:
    """A scenario's schedule codes as an int32 tensor on ``device``, made
    once and kept (no copy a step or a launch, and a launch in flight
    never reads freed memory)."""
    return torch.tensor(codes, dtype=torch.int32, device=device)


def ctmc_chunk_cuda(state: Dict[str, torch.Tensor], us: torch.Tensor,
                    pv: torch.Tensor, R: int, P: int,
                    hist_channels: Sequence[str], *,
                    kind: str = "exponential", n_seg: int = 0,
                    rkind: str = "exponential", n_rseg: int = 0,
                    scen=None, wide: bool = False,
                    inplace: bool = False) -> Dict[str, torch.Tensor]:
    """Launch the kernel: ``us.shape[0]`` steps for every row at once.

    ``kind`` / ``n_seg``, ``rkind`` / ``n_rseg`` and ``scen`` choose the
    instance (see :func:`chunk_layout`): the failure family's, its slot
    instance for a non-exponential repair family, or its scenario instance
    for a fault-domain scenario; a float64 ``age`` lane takes its float64
    twin (:data:`LIBRARY64`); ``wide=True`` the wide twin of that
    instance (:data:`LIBRARY_WIDE` / :data:`LIBRARY_WIDE64`; the engine
    passes :func:`wide_for`).  Returns the new state dict.  By
    default the lanes the kernel writes are cloned first, so ``state`` is
    left as it was (as ``_step_u`` leaves it); ``inplace=True`` writes
    into ``state``'s own tensors, for a caller that owns them.  Takes CUDA
    tensors only and raises on anything :func:`chunk_layout` refuses;
    nothing synchronises.
    """
    global LAUNCHES, LAUNCHES_WIDE, STEPS
    written = WRITTEN + (SLOT_WRITTEN if rkind != "exponential" else ()) \
        + (SCEN_LANES + SCEN_METRICS if scen is not None else ())
    new = dict(state) if inplace else {
        k: v.clone() if k in written else v for k, v in state.items()}
    layout = chunk_layout(new, us, pv, R, P, hist_channels, kind=kind,
                          n_seg=n_seg, rkind=rkind, n_rseg=n_rseg, scen=scen,
                          wide=wide)
    device = new["phase"].device
    if device.type != "cuda":
        _fail(f"the state is on {device}, not a CUDA device")
    if layout["n_rows"] == 0 or layout["n_steps"] == 0:
        return new
    args = _args(layout, schedule_codes(layout["codes"], device)
                 if layout["n_camp"] else None)
    lib = ((LIBRARY_WIDE64 if layout["age64"] else LIBRARY_WIDE) if wide
           else (LIBRARY64 if layout["age64"] else LIBRARY)).load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ctmc_chunk_launch(ctypes.byref(args), stream)
    check_launch(err, f"ctmc_chunk{' wide' if wide else ''} "
                      f"(B={layout['n_rows']}, steps={layout['n_steps']})")
    LAUNCHES += 1
    LAUNCHES_WIDE += wide
    LAUNCHES_BY_KIND[kind] += 1
    LAUNCHES_BY_REPAIR[rkind] += 1
    if scen is not None:
        LAUNCHES_BY_SCEN[kind] += 1
    LAUNCHES_BY_AGE[AGE_DTYPES[layout["age64"]]] += 1
    STEPS += layout["n_steps"]
    return new
