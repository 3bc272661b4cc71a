"""Hopper CUDA kernel for the vectorized DES next-event race.

Counterpart of ``src/repro/kernels/des_step.py`` (the Pallas TPU kernel
``_event_race_kernel``).  The kernel itself lives in
``repro_torch/csrc/event_race.cu``; this module builds it with ``nvcc``
into a plain-C shared library on first use, binds it with ``ctypes`` and
launches it on PyTorch's current stream.

The build (nvcc into ``build/repro_torch/``, named by a hash of the
source) is shared with the other kernels: see :mod:`._build`.

``LAUNCHES`` counts kernel launches (one per :func:`event_race_cuda`
call that reaches the card), so a run can show that its main path went
through the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from ._build import CudaLibrary, check_launch

#: launches of the event-race kernel since import (or the last reset)
LAUNCHES = 0


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.event_race_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("event_race", _bind)


def library_path() -> Path:
    """Where the built library for the current source lives."""
    return LIBRARY.library_path()


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
    lib = LIBRARY.load()
    with torch.cuda.device(rates.device):
        stream = torch.cuda.current_stream(rates.device).cuda_stream
        err = lib.event_race_launch(
            rates.data_ptr(), rates.stride(0),
            residuals.data_ptr(), residuals.stride(0),
            u_time.data_ptr(), u_time.stride(0),
            u_pick.data_ptr(), u_pick.stride(0),
            dt.data_ptr(), event.data_ptr(), R, k_exp,
            residuals.shape[1], stream)
    check_launch(err, f"event_race (R={R}, K_exp={k_exp}, "
                      f"K_det={residuals.shape[1]})")
    LAUNCHES += 1
    return dt, event
