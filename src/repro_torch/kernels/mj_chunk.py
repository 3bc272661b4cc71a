"""Hopper CUDA kernel that runs a chunk of multi-job CTMC steps in one launch.

Counterpart, on the multi-job path, of the Pallas TPU kernel
``src/repro/kernels/des_step.py::_event_race_kernel`` together with the
``lax.scan`` of ``src/repro/core/vectorized_multijob.py::_mj_chunk_loop``
around it: one launch runs a chunk of ``core.vectorized_multijob.
_mj_step_u`` steps for every row of a ``(P * R,)`` batch of J-job clusters
(an instance a job count, J from 1 to :data:`MAX_JOBS`, and above that
the runtime-J instance, :data:`LIBRARY_RT`: one kernel whose loops run
over the launch's J, its rates and residuals in global scratch, a row's
words in shared memory where a block's rows fit and in global memory
where they do not).  The kernel lives
in ``repro_torch/csrc/mj_chunk.cu`` (what it computes, its bound and its
design are noted there); :mod:`._build` builds it with ``nvcc -fmad=false``
on first use and binds it with ``ctypes``, and :func:`mj_chunk_cuda`
launches it on PyTorch's current stream.

The state is the multi-job engine's dict of tensors.  The kernel knows
exactly the lanes of the multi-job step: :func:`mj_chunk_layout` refuses
any other key and any lane dtype or shape but that path's, so a lane that
a later engine adds cannot be dropped without notice.

``LAUNCHES`` counts kernel launches, ``LAUNCHES_BY_J`` the template
instances' by job count, ``LAUNCHES_RT`` the runtime-J instance's and
``STEPS`` the steps they ran, so a run can show that its main path went
through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from ._build import CudaLibrary, check_launch

#: jobs a cluster the template instances take (``kMaxJobs`` of
#: ``csrc/mj_chunk.cu``); the runtime-J instance takes any J
MAX_JOBS = 8

#: launches of the kernel since import (or the last reset)
LAUNCHES = 0
#: the same launches by job count
LAUNCHES_BY_J = dict.fromkeys(range(1, MAX_JOBS + 1), 0)
#: the runtime-J instance's launches among them
LAUNCHES_RT = 0
#: steps those launches ran
STEPS = 0

#: (B, J, 4) per-job compartment blocks, in the kernel's slot order
BLOCKS = ("run", "sb", "auto", "man", "q")
#: (B, 4) shared pools
POOLS = ("fw", "fs")
#: (B, J) float32 per-job lanes
JOB_LANES = ("work_left", "timer", "stall_start", "cur_run")
#: (B, J) float32 per-job metrics (``_MJ_JOB_METRICS``)
JOB_METRICS = ("total_time", "useful_work", "n_failures",
               "n_random_failures", "n_systematic_failures", "n_undiagnosed",
               "n_misdiagnosed", "n_preemptions", "n_host_selections",
               "n_standby_swaps", "stall_time", "recovery_overhead")
#: (B,) float32 cluster metrics (``_MJ_CLUSTER_METRICS``)
CLUSTER_METRICS = ("n_auto_repairs", "n_manual_repairs", "n_failed_repairs",
                   "stall_handoffs", "n_shop_queued", "conservation_err")
#: (B, J) int32 lanes
INT_LANES = ("phase", "n_runs")
#: histogram channels by kernel code: the multi-job step's three
CHANNELS = ("run_duration", "recovery", "waiting")
#: shared parameter columns before the J warm-standby targets
N_SHARED_COLS = 14
#: uniforms a step
N_UNIFORMS = 10

#: every lane the kernel writes (cloned unless the caller owns the state)
WRITTEN = (BLOCKS + POOLS + ("t",) + JOB_LANES + JOB_METRICS
           + CLUSTER_METRICS + INT_LANES + ("run_durations", "hist"))
_KNOWN = frozenset(WRITTEN + ("fleet_total", "hist_edges"))
_MAX_SHARED = 227 * 1024
#: 32-bit words of shared memory a row of a J-job instance: the five
#: blocks, the two cached quotient blocks, the per-job lanes and metrics,
#: phase and n_runs
_WORDS_A_JOB = 7 * 4 + len(JOB_LANES) + len(JOB_METRICS) + 2


class MjChunkArgs(ctypes.Structure):
    """``MjChunkArgs`` of ``csrc/mj_chunk.cu``, field for field."""
    _fields_ = [("block", ctypes.c_void_p * len(BLOCKS)),
                ("pool", ctypes.c_void_p * len(POOLS)),
                ("job_lane", ctypes.c_void_p * len(JOB_LANES)),
                ("job_metric", ctypes.c_void_p * len(JOB_METRICS)),
                ("cluster_metric", ctypes.c_void_p * len(CLUSTER_METRICS)),
                ("t", ctypes.c_void_p), ("fleet_total", ctypes.c_void_p),
                ("phase", ctypes.c_void_p), ("n_runs", ctypes.c_void_p),
                ("run_durations", ctypes.c_void_p),
                ("hist", ctypes.c_void_p), ("hist_edges", ctypes.c_void_p),
                ("pv", ctypes.c_void_p), ("us", ctypes.c_void_p),
                ("pv_stride", ctypes.c_int64), ("n_rows", ctypes.c_int64),
                ("R", ctypes.c_int64), ("R_draw", ctypes.c_int64),
                ("n_steps", ctypes.c_int32), ("max_runs", ctypes.c_int32),
                ("n_sel", ctypes.c_int32), ("n_edges", ctypes.c_int32),
                ("chan", ctypes.c_int32 * 3), ("n_jobs", ctypes.c_int32),
                ("rows_per_block", ctypes.c_int32)]


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.mj_chunk_launch
    fn.argtypes = [ctypes.POINTER(MjChunkArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _bind_rt(lib: ctypes.CDLL) -> None:
    fn = lib.mj_chunk_rt_launch
    fn.argtypes = [ctypes.POINTER(MjChunkArgs), ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("mj_chunk", _bind, extra_flags=("-fmad=false",))
#: the runtime-J instance, from the same source (``-DMJ_RUNTIME_J``)
LIBRARY_RT = CudaLibrary("mj_chunk_rt", _bind_rt,
                         extra_flags=("-fmad=false", "-DMJ_RUNTIME_J"),
                         source="mj_chunk")
#: float words of a row's rates and residuals in the runtime-J
#: instance's scratch, a job
RT_RATE_WORDS = 18


def _fail(msg: str) -> None:
    raise ValueError(f"mj_chunk: {msg}")


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


def rows_per_block(J: int, n_edges: int = 0, widest: int = 128) -> int:
    """Rows a block of a J-job launch: ``widest``, halved (down to 32)
    until the block's shared memory (the edges, then the row's words) fits
    an H100 block; raises ``ValueError`` where even 32 rows do not fit.
    The launches take 128 (on an H100, 128 rows a block ran phase 20's
    2,048 rows 6-7% faster than 32; ``scripts/torch_mj_chunk_variants.py``
    times 32, 64 and 128).

    >>> rows_per_block(3, 130), rows_per_block(8, 20000)
    (128, 64)
    """
    rows = widest
    edge_words = -(-n_edges // 4) * 4

    def smem(n):
        return 4 * (edge_words + n * _WORDS_A_JOB * J)

    while rows > 32 and smem(rows) > _MAX_SHARED:
        rows //= 2
    if smem(rows) > _MAX_SHARED:
        _fail(f"{n_edges} histogram edges and {J} jobs need {smem(rows)} "
              f"bytes of shared memory a block, over the {_MAX_SHARED} an "
              "H100 block takes")
    return rows


def rt_plan(J: int, n_edges: int = 0) -> dict:
    """The runtime-J instance's launch: ``rows`` a block and whether a
    row's words go to global memory (``global_words``, where even 32 rows
    of J jobs do not fit a block's shared memory beside the edges).

    >>> rt_plan(9, 130), rt_plan(40, 130)
    ({'rows': 128, 'global_words': False}, {'rows': 128, 'global_words': True})
    """
    try:
        return {"rows": rows_per_block(J, n_edges), "global_words": False}
    except ValueError:
        rows_per_block(0, n_edges)   # the edges alone must fit
        return {"rows": 128, "global_words": True}


def runtime_for(J: int) -> bool:
    """Whether a J-job chunk runs the runtime-J instance (J above
    :data:`MAX_JOBS`) rather than its template instance."""
    return J > MAX_JOBS


def mj_chunk_layout(state: Dict[str, torch.Tensor], us: torch.Tensor,
                    pv: torch.Tensor, R: int, P: int, J: int,
                    hist_channels: Sequence[str], *,
                    runtime: bool = False) -> dict:
    """The launch's layout, after every check the kernel needs.

    ``state`` is the multi-job engine's state dict over ``B = P * R`` rows
    of J-job clusters, ``us`` one chunk's ``(n_steps, R_draw, 10)``
    float32 draw with ``R_draw >= R``, ``pv`` one shared parameter row of
    ``14 + J`` columns or a ``(B, 14 + J)`` matrix, ``hist_channels`` the
    channels ``state["hist"]`` carries.  Returns a dict: ``pointers``
    (lane name -> data pointer), ``pv_stride`` (0 for a shared row),
    ``n_rows``, ``R``, ``P``, ``J``, ``R_draw``, ``n_steps``,
    ``max_runs``, ``n_sel``, ``n_edges``, ``chan`` (the kernel's code of
    each carried channel, its index in :data:`CHANNELS`), ``rows`` (rows
    a block), ``runtime`` and ``global_words`` (the runtime-J instance's
    words in global memory).  Raises ``ValueError`` on a job count above
    :data:`MAX_JOBS` (any J >= 1 for ``runtime=True``, the runtime-J
    instance), a key the kernel does not know or lacks, or a dtype, shape,
    device, stride or alignment it does not take.  Works on tensors of any
    device.
    """
    if not isinstance(J, int) or not 1 <= J <= (2 ** 31 - 1 if runtime
                                                else MAX_JOBS):
        _fail(f"{J} jobs; the kernel takes 1..{MAX_JOBS} jobs a cluster "
              f"(run a larger cluster through the plain step loop, "
              f"impl=\"ref\")")
    unknown = sorted(set(state) - _KNOWN)
    if unknown:
        _fail(f"state keys {unknown} are lanes the kernel does not carry "
              "(it runs the multi-job step)")
    has_hist = "hist" in state
    needed = set(_KNOWN) - ({"hist", "hist_edges"} if not has_hist else set())
    missing = sorted(needed - set(state))
    if missing:
        _fail(f"state lacks {missing}")
    phase = state["phase"]
    device = phase.device
    B = phase.shape[0] if phase.ndim == 2 else -1
    if B != P * R or R < 1 or phase.shape[1] != J:
        _fail(f"phase {tuple(phase.shape)} is not (P * R, J) = ({P} * {R}, "
              f"{J})")
    f32 = torch.float32
    for k in BLOCKS:
        _check(k, state[k], (B, J, 4), f32, device)
    for k in POOLS:
        _check(k, state[k], (B, 4), f32, device)
    for k in ("t", "fleet_total") + CLUSTER_METRICS:
        _check(k, state[k], (B,), f32, device)
    for k in JOB_LANES + JOB_METRICS:
        _check(k, state[k], (B, J), f32, device)
    for k in INT_LANES:
        _check(k, state[k], (B, J), torch.int32, device)
    ring = state["run_durations"]
    max_runs = ring.shape[2] if ring.ndim == 3 else -1
    _check("run_durations", ring, (B, J, max_runs), f32, device)
    n_sel = n_edges = 0
    chan = [0, 0, 0]
    if has_hist:
        edges = state["hist_edges"]
        n_edges = edges.shape[0] if edges.ndim == 1 else 0
        _check("hist_edges", edges, (n_edges,), f32, device)
        if n_edges < 1:
            _fail("no histogram edges")
        hist_channels = tuple(hist_channels)
        n_sel = len(hist_channels)
        if not 1 <= n_sel <= 3 or any(c not in CHANNELS
                                      for c in hist_channels):
            _fail(f"histogram channels {hist_channels} are not 1-3 of "
                  f"{CHANNELS} (the multi-job step carries those)")
        _check("hist", state["hist"], (B, J, n_sel, n_edges + 1), f32,
               device)
        for i, c in enumerate(hist_channels):
            chan[i] = CHANNELS.index(c)
    if us.ndim != 3 or us.shape[2] != N_UNIFORMS or us.shape[1] < R:
        _fail(f"uniforms {tuple(us.shape)} are not (n_steps, R_draw >= {R}, "
              f"{N_UNIFORMS})")
    _check("uniforms", us, tuple(us.shape), f32, device)
    if us.shape[0] >= 2 ** 31:
        _fail(f"{us.shape[0]} steps in one launch")
    width = N_SHARED_COLS + J
    if pv.ndim == 1:
        _check("pv", pv, (width,), f32, device)
        pv_stride = 0
    elif pv.ndim == 2 and pv.shape[0] == B:
        if pv.dtype != f32 or pv.device != device or (pv.shape[1] > 1
                                                     and pv.stride(1) != 1):
            _fail(f"pv {pv.dtype} on {pv.device} with strides {pv.stride()}"
                  " is not float32 rows on the state's device")
        if pv.shape[1] != width:
            _fail(f"pv has {pv.shape[1]} columns; the {J}-job step reads "
                  f"{width} (14 shared, then a warm-standby target a job)")
        pv_stride = pv.stride(0)
    else:
        _fail(f"pv {tuple(pv.shape)} is neither one row of {width} columns "
              f"nor (B={B}, {width})")
    pointers = {k: v.data_ptr() for k, v in state.items()}
    pointers.update(pv=pv.data_ptr(), us=us.data_ptr())
    # the blocks and pools load as float4, the uniform rows as float2
    for k in BLOCKS + POOLS:
        if pointers[k] % 16:
            _fail(f"{k} is not 16-byte aligned (the kernel loads it as "
                  "float4)")
    if pointers["us"] % 8:
        _fail("uniforms are not 8-byte aligned (the kernel loads them as "
              "float2)")
    plan = rt_plan(J, n_edges) if runtime else {
        "rows": rows_per_block(J, n_edges), "global_words": False}
    return {"pointers": pointers, "pv_stride": pv_stride, "n_rows": B,
            "R": R, "P": P, "J": J, "R_draw": us.shape[1],
            "n_steps": us.shape[0], "max_runs": max_runs, "n_sel": n_sel,
            "n_edges": n_edges, "chan": tuple(chan), "runtime": runtime,
            **plan}


def _args(layout: dict) -> MjChunkArgs:
    """The launch's struct."""
    ptr = layout["pointers"]
    args = MjChunkArgs()
    args.block[:] = [ptr[k] for k in BLOCKS]
    args.pool[:] = [ptr[k] for k in POOLS]
    args.job_lane[:] = [ptr[k] for k in JOB_LANES]
    args.job_metric[:] = [ptr[k] for k in JOB_METRICS]
    args.cluster_metric[:] = [ptr[k] for k in CLUSTER_METRICS]
    for k in ("t", "fleet_total", "phase", "n_runs", "pv", "us"):
        setattr(args, k, ptr[k])
    args.run_durations = ptr["run_durations"] if layout["max_runs"] else None
    args.hist = ptr.get("hist")
    args.hist_edges = ptr.get("hist_edges")
    for k in ("pv_stride", "n_rows", "R", "R_draw", "n_steps", "max_runs",
              "n_sel", "n_edges"):
        setattr(args, k, layout[k])
    args.chan[:] = list(layout["chan"])
    args.n_jobs = layout["J"]
    args.rows_per_block = layout["rows"]
    return args


def mj_chunk_cuda(state: Dict[str, torch.Tensor], us: torch.Tensor,
                  pv: torch.Tensor, R: int, P: int, J: int,
                  hist_channels: Sequence[str], *, runtime: bool = False,
                  inplace: bool = False) -> Dict[str, torch.Tensor]:
    """Launch the kernel: ``us.shape[0]`` multi-job steps for every row.

    ``runtime=True`` launches the runtime-J instance (:data:`LIBRARY_RT`;
    the engine passes :func:`runtime_for`), which takes any J and gets its
    scratch (``(B, 18 J)`` rates and residuals, and ``(B, 46 J)`` words
    where :func:`rt_plan` puts them in global memory) from the wrapper.

    Returns the new state dict.  By default the lanes the kernel writes
    are cloned first, so ``state`` is left as it was (as ``_mj_step_u``
    leaves it); ``inplace=True`` writes into ``state``'s own tensors, for a
    caller that owns them.  Takes CUDA tensors only and raises on
    anything :func:`mj_chunk_layout` refuses; nothing synchronises.
    """
    global LAUNCHES, LAUNCHES_RT, STEPS
    new = dict(state) if inplace else {
        k: v.clone() if k in WRITTEN else v for k, v in state.items()}
    layout = mj_chunk_layout(new, us, pv, R, P, J, hist_channels,
                             runtime=runtime)
    device = new["phase"].device
    if device.type != "cuda":
        _fail(f"the state is on {device}, not a CUDA device")
    if layout["n_rows"] == 0 or layout["n_steps"] == 0:
        return new
    args = _args(layout)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if runtime:
            B = layout["n_rows"]
            rates = torch.empty((B, RT_RATE_WORDS * J), dtype=torch.float32,
                                device=device)
            words = torch.empty((B, _WORDS_A_JOB * J), dtype=torch.float32,
                                device=device) \
                if layout["global_words"] else None
            err = LIBRARY_RT.load().mj_chunk_rt_launch(
                ctypes.byref(args), rates.data_ptr(),
                None if words is None else words.data_ptr(), stream)
        else:
            err = LIBRARY.load().mj_chunk_launch(ctypes.byref(args), stream)
    check_launch(err, f"mj_chunk{' runtime-J' if runtime else ''} "
                      f"(B={layout['n_rows']}, J={J}, "
                      f"steps={layout['n_steps']})")
    LAUNCHES += 1
    if runtime:
        LAUNCHES_RT += 1
    else:
        LAUNCHES_BY_J[J] += 1
    STEPS += layout["n_steps"]
    return new
