"""Hopper CUDA kernel for the Mamba-1 selective scan (forward).

Counterpart of ``src/repro/kernels/mamba_scan.py`` (the Pallas TPU kernel
``_mamba_kernel``).  The kernel lives in ``repro_torch/csrc/mamba_scan.cu``;
:mod:`._build` builds it with ``nvcc`` on first use and binds it with
``ctypes``, and :func:`selective_scan_cuda` launches it on PyTorch's
current stream.

``LAUNCHES`` counts kernel launches, so a run can show that its main
path went through the kernel.  :func:`launch_plan` decides what the
kernel is told besides the tensors: the lanes a channel's N states are
split over, and for each of x, dt, B, C and y the widest copy that every
row of it is aligned to.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ._build import CudaLibrary, check_launch

#: launches of the scan kernel since import (or the last reset)
LAUNCHES = 0

#: state sizes N the kernel is compiled for
STATE_SIZES = (8, 16)

#: lanes that split one channel's N states (``kLanes`` in the kernel)
LANES = 2

#: channels of d_inner a block takes, and time steps a ring stage holds
#: (``kChannels`` and ``kSpan`` in the kernel)
BLOCK_CHANNELS, SPAN = 64, 32

_DTYPES = (torch.float32, torch.bfloat16)
_INT32_MAX = 2 ** 31 - 1


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn = lib.selective_scan_launch
    fn.argtypes = [ptr, i64, i64, ptr, i64, i64, ptr, ptr, i64, i64,
                   ptr, i64, i64, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                   i32, i32, i32, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("mamba_scan", _bind)


def check_args(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bmat: torch.Tensor, Cmat: torch.Tensor,
               h0: Optional[torch.Tensor]) -> None:
    """Refuse what the kernel does not take (shapes, types, limits)."""
    if x.ndim != 3 or dt.shape != x.shape:
        raise ValueError(f"selective_scan: x {tuple(x.shape)} and dt "
                         f"{tuple(dt.shape)} must be one (B, S, di) shape")
    Bsz, S, di = x.shape
    if A.ndim != 2 or A.shape[0] != di:
        raise ValueError(f"selective_scan: A {tuple(A.shape)} is not "
                         f"(d_inner={di}, N)")
    N = A.shape[1]
    if N not in STATE_SIZES:
        raise ValueError(f"selective_scan: state size N={N} is not one the "
                         f"kernel is built for {STATE_SIZES}")
    for name, t in (("B", Bmat), ("C", Cmat)):
        if t.shape != (Bsz, S, N):
            raise ValueError(f"selective_scan: {name} {tuple(t.shape)} is "
                             f"not (B, S, N) = {(Bsz, S, N)}")
    if h0 is not None and (h0.shape != (Bsz, di, N)
                           or h0.dtype != torch.float32):
        raise ValueError(f"selective_scan: h0 {tuple(h0.shape)} "
                         f"{h0.dtype} is not float32 (B, di, N) = "
                         f"{(Bsz, di, N)}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype
                                     for t in (dt, Bmat, Cmat)):
        raise ValueError(f"selective_scan: dtypes {x.dtype}, {dt.dtype}, "
                         f"{Bmat.dtype}, {Cmat.dtype}; the kernel takes "
                         "float32 or bfloat16, the same for x, dt, B and C")
    if A.dtype != torch.float32:
        raise ValueError(f"selective_scan: A is {A.dtype}, not float32")
    if Bsz == 0 or di == 0:
        raise ValueError(f"selective_scan: empty batch or channels "
                         f"{tuple(x.shape)}")
    if max(Bsz, S, di) > _INT32_MAX or Bsz > 65535:
        raise ValueError(f"selective_scan: shape {tuple(x.shape)} exceeds "
                         "the kernel's grid")


@dataclass(frozen=True)
class LaunchPlan:
    """What :func:`selective_scan_cuda` tells the kernel besides tensors."""

    lanes: int                  #: lanes that split a channel's N states
    #: threads a block: BLOCK_CHANNELS * lanes consumers, one producer warp
    threads: int
    grid: Tuple[int, int]       #: (channel blocks, batch)
    #: bytes a copy for x, dt, B, C (global -> shared) and y (shared ->
    #: global): 16, 8, 4 or one element
    widths: Tuple[int, int, int, int, int]
    smem_bytes: int             #: dynamic shared memory a block


def _copy_width(t: torch.Tensor, row_len: int) -> int:
    """Widest copy (16, 8 or 4 bytes, else one element) that every row of
    ``t``'s last dim starts on and that divides ``row_len`` elements of
    it, so that a copy is wholly inside or wholly outside a row.  A stride
    of a dim of size 1 is never used and does not count."""
    es = t.element_size()
    offsets = [t.data_ptr(), row_len * es] + [
        t.stride(d) * es for d in range(t.ndim - 1) if t.shape[d] > 1]
    for w in (16, 8, 4):
        if w >= es and all(o % w == 0 for o in offsets):
            return w
    return es


def launch_plan(x: torch.Tensor, dt: torch.Tensor, Bmat: torch.Tensor,
                Cmat: torch.Tensor) -> LaunchPlan:
    """The kernel's launch for these (checked) inputs on any device.

    y is allocated contiguous by the wrapper (PyTorch aligns a new
    tensor to at least 16 bytes), so its width follows from d_inner
    alone.  Shared memory, two spans of each: x, dt (SPAN x
    BLOCK_CHANNELS) and B, C (SPAN x N) in the inputs' type, y in it,
    and in bf16 B and C converted to fp32.
    """
    Bsz, _, di = x.shape
    N = Bmat.shape[-1]
    es = x.element_size()
    y_width = next((w for w in (16, 8, 4) if w >= es and di * es % w == 0),
                   es)
    stage = 2 * SPAN * BLOCK_CHANNELS * es + 2 * SPAN * N * es
    y_span = SPAN * BLOCK_CHANNELS * es
    converted = SPAN * 2 * N * 4 if es == 2 else 0
    return LaunchPlan(
        lanes=LANES, threads=BLOCK_CHANNELS * LANES + 32,
        grid=(-(-di // BLOCK_CHANNELS), Bsz),
        widths=(_copy_width(x, di), _copy_width(dt, di),
                _copy_width(Bmat, N), _copy_width(Cmat, N), y_width),
        smem_bytes=2 * (stage + y_span + converted))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernel moves A, h0 and
    h_final as float4 rows)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def selective_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        Bmat: torch.Tensor, Cmat: torch.Tensor,
                        h0: Optional[torch.Tensor] = None,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: ``(y (B, S, di) in x's dtype, h_final (B, di, N)
    float32)``.

    x, dt (B, S, di) and B, C (B, S, N) are CUDA tensors of one dtype
    (float32 or bfloat16) whose last dim is contiguous; their batch and
    time strides are passed through, so B and C may be column slices of
    one projection.  A (di, N) is float32; h0 (B, di, N) float32, zeros
    when None.  Any S and di run the kernel.  Raises on anything the
    kernel does not take; nothing synchronises.
    """
    global LAUNCHES
    check_args(x, dt, A, Bmat, Cmat, h0)
    Bsz, S, di = x.shape
    N = A.shape[1]
    if h0 is None:
        h0 = torch.zeros((Bsz, di, N), dtype=torch.float32, device=x.device)
    A, h0 = _aligned(A), _aligned(h0)
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", Bmat),
                    ("C", Cmat), ("h0", h0)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"selective_scan_cuda: {name} is on "
                             f"{t.device}, not a CUDA device (or not x's)")
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"selective_scan_cuda: {name} last dim must be "
                             f"contiguous (strides {t.stride()})")
    plan = launch_plan(x, dt, Bmat, Cmat)
    y = torch.empty((Bsz, S, di), dtype=x.dtype, device=x.device)
    h_final = torch.empty((Bsz, di, N), dtype=torch.float32, device=x.device)
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.selective_scan_launch(
            x.data_ptr(), x.stride(0), x.stride(1),
            dt.data_ptr(), dt.stride(0), dt.stride(1), A.data_ptr(),
            Bmat.data_ptr(), Bmat.stride(0), Bmat.stride(1),
            Cmat.data_ptr(), Cmat.stride(0), Cmat.stride(1),
            h0.data_ptr(), y.data_ptr(), h_final.data_ptr(), Bsz, S, di, N,
            plan.lanes, *plan.widths, int(x.dtype == torch.bfloat16),
            stream)
    check_launch(err, f"selective_scan (x {tuple(x.shape)}, N={N}, "
                      f"{x.dtype})")
    LAUNCHES += 1
    return y, h_final
