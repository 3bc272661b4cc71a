"""Hopper CUDA kernel for the vectorized DES next-event race.

Counterpart of ``src/repro/kernels/des_step.py`` (the Pallas TPU kernel
``_event_race_kernel``).  The kernel itself lives in
``repro_torch/csrc/event_race.cu``; this module builds it with ``nvcc``
into a plain-C shared library on first use, binds it with ``ctypes`` and
launches it on PyTorch's current stream.

The library lands in ``build/repro_torch/`` at the repository root,
named by a hash of the source's contents, so an edited ``.cu`` builds
anew and an unchanged one is reused.  Nothing is built or imported at
module import: the CPU tests import this module on a machine with no
``nvcc`` and no card.

``LAUNCHES`` counts kernel launches (one per :func:`event_race_cuda`
call that reaches the card), so a run can show that its main path went
through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

#: launches of the event-race kernel since import (or the last reset)
LAUNCHES = 0

#: seconds the last build took (0.0 when a built library was reused)
BUILD_SECONDS = 0.0

#: nvcc's output from the last build (``-Xptxas -v`` register report)
BUILD_LOG = ""

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "event_race.cu"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME/bin, default "
        "/usr/local/cuda/bin): the event-race CUDA kernel is built from "
        "source at first use and needs the CUDA toolkit")


def library_path() -> Path:
    """Where the built library for the current source lives."""
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"event_race_{digest}.so"


def build() -> Path:
    """Build the kernel library if this source has not been built yet."""
    global BUILD_SECONDS, BUILD_LOG
    out = library_path()
    if out.exists():
        BUILD_SECONDS = 0.0
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build into a temporary name and rename, so a concurrent or cut
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", tmp,
                               str(_SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {_SOURCE} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = proc.stdout + proc.stderr
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.event_race_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(rates: torch.Tensor, residuals: torch.Tensor,
           u_time: torch.Tensor, u_pick: torch.Tensor) -> None:
    named = (("rates", rates), ("residuals", residuals),
             ("u_time", u_time), ("u_pick", u_pick))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"event_race_cuda: {name} is on {t.device}, "
                             "not a CUDA device")
        if t.device != rates.device:
            raise ValueError(f"event_race_cuda: {name} is on {t.device}, "
                             f"rates on {rates.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"event_race_cuda: {name} has dtype {t.dtype}; "
                             "the kernel takes float32")
    if rates.ndim != 2 or residuals.ndim != 2:
        raise ValueError("event_race_cuda: rates and residuals must be 2-D "
                         f"(got {tuple(rates.shape)}, "
                         f"{tuple(residuals.shape)})")
    R = rates.shape[0]
    if residuals.shape[0] != R or u_time.shape != (R,) \
            or u_pick.shape != (R,):
        raise ValueError(
            f"event_race_cuda: row counts disagree: rates "
            f"{tuple(rates.shape)}, residuals {tuple(residuals.shape)}, "
            f"u_time {tuple(u_time.shape)}, u_pick {tuple(u_pick.shape)}")
    for name, t in named[:2]:
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"event_race_cuda: {name} lanes must be "
                             f"contiguous (stride {t.stride()})")
    if rates.shape[1] == 0 or residuals.shape[1] == 0:
        raise ValueError("event_race_cuda: zero-width lane block")


def event_race_cuda(rates: torch.Tensor, residuals: torch.Tensor,
                    u_time: torch.Tensor, u_pick: torch.Tensor,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: ``(dt (R,) f32, event (R,) i32)``.

    Takes CUDA float32 tensors only and raises on anything else.  Row
    strides are passed through, so strided views such as ``u[:, 0]`` go
    in without a copy.  Outputs are allocated here; nothing synchronises.
    """
    global LAUNCHES
    _check(rates, residuals, u_time, u_pick)
    R, k_exp = rates.shape
    dt = torch.empty((R,), dtype=torch.float32, device=rates.device)
    event = torch.empty((R,), dtype=torch.int32, device=rates.device)
    if R == 0:
        return dt, event
    lib = _load()
    with torch.cuda.device(rates.device):
        stream = torch.cuda.current_stream(rates.device).cuda_stream
        err = lib.event_race_launch(
            rates.data_ptr(), rates.stride(0),
            residuals.data_ptr(), residuals.stride(0),
            u_time.data_ptr(), u_time.stride(0),
            u_pick.data_ptr(), u_pick.stride(0),
            dt.data_ptr(), event.data_ptr(), R, k_exp,
            residuals.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"event_race kernel launch failed: CUDA error "
                           f"{err} (R={R}, K_exp={k_exp}, "
                           f"K_det={residuals.shape[1]})")
    LAUNCHES += 1
    return dt, event
