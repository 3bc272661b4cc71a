"""Hopper CUDA kernel for grouped-query flash attention (forward).

Counterpart of ``src/repro/kernels/flash_attention.py`` (the Pallas TPU
kernel ``_flash_kernel``).  The kernel lives in
``repro_torch/csrc/flash_attention.cu``; :mod:`._build` builds it with
``nvcc`` on first use and binds it with ``ctypes``, and
:func:`flash_attention_cuda` launches it on PyTorch's current stream.

``LAUNCHES`` counts kernel launches, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._build import CudaLibrary, check_launch

#: launches of the attention kernel since import (or the last reset)
LAUNCHES = 0

#: head dims the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128)

_DTYPES = (torch.float32, torch.bfloat16)
_INT32_MAX = 2 ** 31 - 1


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn = lib.flash_attention_launch
    fn.argtypes = ([ptr, i64, i64, i64] * 3 + [ptr] + [i32] * 10 + [ptr])
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("flash_attention", _bind)


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               q_offset: int, kv_len: Optional[int]) -> None:
    """Refuse what the kernel does not take (shapes, types, limits)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D (B, S, H, d) "
                         f"(got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)})")
    B, Sq, Hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    Sk, Hkv = k.shape[1], k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: {Hq} query heads are not a "
                         f"multiple of {Hkv} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} is not one the "
                         f"kernel is built for {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; the kernel takes float32 or bfloat16, "
                         "the same for q, k and v")
    if Sk == 0:
        raise ValueError("flash_attention: no keys (Sk = 0)")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    if kv_len is not None and kv_len < 1:
        raise ValueError(f"flash_attention: kv_len {kv_len} < 1 would leave "
                         "every query row without a key")
    if max(B * Hq, Sq, Sk, q_offset + Sq) > _INT32_MAX:
        raise ValueError("flash_attention: sizes exceed 32-bit indices")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, q_offset: int = 0,
                         kv_len: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel: ``(B, Sq, Hq, d)`` in q's dtype, contiguous.

    q (B, Sq, Hq, d), k/v (B, Sk, Hkv, d), CUDA tensors of one dtype
    (float32 or bfloat16) whose last dim is contiguous; batch, sequence
    and head strides are passed through, so a KV-cache view goes in
    without a copy.  ``q_offset`` and ``kv_len`` are host integers; any
    Sq and Sk run the kernel.  Raises on anything the kernel does not
    take; nothing synchronises.
    """
    global LAUNCHES
    check_args(q, k, v, q_offset, kv_len)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention_cuda: {name} is on "
                             f"{t.device}, not a CUDA device (or not q's)")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention_cuda: {name} head dim must "
                             f"be contiguous (strides {t.stride()})")
    B, Sq, Hq, d = q.shape
    out = torch.empty((B, Sq, Hq, d), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0:
        return out
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
            k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
            v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
            out.data_ptr(), B, Sq, k.shape[1], Hq, k.shape[2], d,
            int(causal), q_offset,
            -1 if kv_len is None else min(kv_len, k.shape[1]),
            int(q.dtype == torch.bfloat16), stream)
    check_launch(err, f"flash_attention (q {tuple(q.shape)}, k "
                      f"{tuple(k.shape)}, {q.dtype})")
    LAUNCHES += 1
    return out
