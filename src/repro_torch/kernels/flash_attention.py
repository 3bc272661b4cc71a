"""Hopper CUDA kernels for grouped-query flash attention (forward).

Counterpart of ``src/repro/kernels/flash_attention.py`` (the Pallas TPU
kernel ``_flash_kernel``).  The kernels live in
``repro_torch/csrc/flash_attention.cu``; :mod:`._build` builds them with
``nvcc`` on first use and binds them with ``ctypes``, and
:func:`flash_attention_cuda` launches them on PyTorch's current stream.

Which kernel takes a call (the routing rule):

* float32: the SIMT kernel (fp32 FMAs on the CUDA cores).
* bfloat16 with at most :data:`DECODE_MAX_ROWS` query rows per KV head
  (``Sq * Hq / Hkv``; a decode step has Sq = 1): the split-KV decode
  kernel over the splits of :func:`plan_decode_splits`, then the merge
  kernel -- two device kernels for the call.
* any other bfloat16 call (prefill): the tensor-core tile kernel.

``LAUNCHES`` counts attention calls that launched, one per call whatever
the number of device kernels, so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ._build import CudaLibrary, check_launch

#: attention calls that launched the kernels since import (or the last reset)
LAUNCHES = 0

#: head dims the kernels are compiled for
HEAD_DIMS = (16, 32, 64, 128)

#: bfloat16 calls with at most this many query rows per KV head take the
#: split-KV decode kernel (one block holds them all, four warps of 16)
DECODE_MAX_ROWS = 64
#: keys of a decode split are a multiple of this (one m16n8k16 step)
SPLIT_KEY_MULTIPLE = 16
#: query rows a block of the bfloat16 tile kernel / the float32 kernel takes
_TILE_ROWS = {torch.bfloat16: 64, torch.float32: 16}

_DTYPES = (torch.float32, torch.bfloat16)
_INT32_MAX = 2 ** 31 - 1
_GRID_Y_MAX = 65535


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn = lib.flash_attention_launch
    fn.argtypes = ([ptr, i64, i64, i64] * 3 + [ptr, ptr, ptr] + [i32] * 12
                   + [ptr])
    fn.restype = ctypes.c_int
    lib.flash_attention_mma_tile.argtypes = [ptr] * 6
    lib.flash_attention_mma_tile.restype = ctypes.c_int


LIBRARY = CudaLibrary("flash_attention", _bind)


def takes_decode(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether the routing rule sends the call to the split-KV decode."""
    rows = q.shape[1] * (q.shape[2] // k.shape[2])
    return q.dtype == torch.bfloat16 and rows <= DECODE_MAX_ROWS


def plan_decode_splits(n_keys: int, n_heads: int, n_sm: int,
                       ) -> Tuple[int, int]:
    """Split ``n_keys`` keys for the decode kernel: ``(n_split, keys)``.

    ``n_heads`` is B * Hkv, one block per head and split.  The splits are
    sized so that the grid covers ``n_sm`` SMs at least once, each a
    multiple of :data:`SPLIT_KEY_MULTIPLE` keys; split i covers keys
    ``[i * keys, min((i + 1) * keys, n_keys))``.  Those ranges cover
    ``[0, n_keys)`` exactly and none is empty, since
    ``n_split = ceil(n_keys / keys)``.

    >>> plan_decode_splits(528, 8, 132)
    (17, 32)
    >>> plan_decode_splits(1, 8, 132)
    (1, 16)
    """
    if n_keys < 1 or n_heads < 1 or n_sm < 1:
        raise ValueError(f"plan_decode_splits: n_keys {n_keys}, n_heads "
                         f"{n_heads}, n_sm {n_sm} must be >= 1")
    want = -(-n_sm // n_heads)                 # splits per head
    keys = -(-n_keys // want)
    keys = -(-keys // SPLIT_KEY_MULTIPLE) * SPLIT_KEY_MULTIPLE
    return -(-n_keys // keys), keys


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    # grid.y: B * Hkv for the decode, the query tiles for the other kernels
    if takes_decode(q, k):
        if B * Hkv > _GRID_Y_MAX:
            raise ValueError(f"flash_attention: B * Hkv {B * Hkv} exceeds "
                             "the decode kernel's grid")
    elif -(-Sq // _TILE_ROWS[q.dtype]) > _GRID_Y_MAX:
        raise ValueError(f"flash_attention: Sq {Sq} exceeds the kernel's "
                         "grid")


def check_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Refuse a layout the kernels cannot read: the head dim must be
    contiguous, and for bfloat16 every row must start on 16 bytes (the
    kernels load 16-byte chunks), so each data pointer is 16-byte aligned
    and each batch, sequence and head stride a multiple of 8 elements.
    The stride of a dim of size 1 is never used and is not checked."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention_cuda: {name} head dim must "
                             f"be contiguous (strides {t.stride()})")
        if t.dtype != torch.bfloat16:
            continue
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda: {name}'s data pointer "
                             f"is not 16-byte aligned ({t.data_ptr():#x}); "
                             "the bfloat16 kernels load 16-byte chunks")
        bad = [t.stride(i) for i in range(3)
               if t.shape[i] > 1 and t.stride(i) % 8]
        if bad:
            raise ValueError(f"flash_attention_cuda: {name}'s strides "
                             f"{t.stride()} are not multiples of 8 elements "
                             "(16 bytes); the bfloat16 kernels load 16-byte "
                             "chunks")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, q_offset: int = 0,
                         kv_len: Optional[int] = None,
                         return_lse: bool = False):
    """Launch the kernels: ``(B, Sq, Hq, d)`` in q's dtype, contiguous;
    with ``return_lse``, also each query row's log-sum-exp of its visible
    scaled scores, ``(B, Sq, Hq)`` float32, from the same launch.

    q (B, Sq, Hq, d), k/v (B, Sk, Hkv, d), CUDA tensors of one dtype
    (float32 or bfloat16) whose last dim is contiguous; batch, sequence
    and head strides are passed through, so a KV-cache view goes in
    without a copy.  ``q_offset`` and ``kv_len`` are host integers; any
    Sq and Sk run a kernel, chosen by the routing rule of this module.
    Raises on anything the kernels do not take; nothing synchronises.
    """
    global LAUNCHES
    check_args(q, k, v, q_offset, kv_len)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention_cuda: {name} is on "
                             f"{t.device}, not a CUDA device (or not q's)")
    check_layout(q, k, v)
    B, Sq, Hq, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, Hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Sq, Hq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if B == 0 or Sq == 0:
        return (out, lse) if return_lse else out
    key_limit = Sk if kv_len is None else min(kv_len, Sk)
    rows = Sq * (Hq // Hkv)
    part, n_split, split_keys = None, 0, 0
    if takes_decode(q, k):
        n_keys = min(key_limit, q_offset + Sq) if causal else key_limit
        n_split, split_keys = plan_decode_splits(
            n_keys, B * Hkv, _sm_count(q.device.index))
        # freed on return: the caching allocator hands it out again only
        # to work queued after this launch on the same stream
        part = torch.empty(B * Hkv * n_split * rows * (d + 2),
                           dtype=torch.float32, device=q.device)
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
            k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
            v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
            out.data_ptr(), None if part is None else part.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, Sq, Sk, Hq, Hkv, d, int(causal), q_offset,
            -1 if kv_len is None else key_limit,
            int(q.dtype == torch.bfloat16), n_split, split_keys, stream)
    check_launch(err, f"flash_attention (q {tuple(q.shape)}, k "
                      f"{tuple(k.shape)}, {q.dtype})")
    LAUNCHES += 1
    return (out, lse) if return_lse else out


def mma_tile(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One m16n8k16 tile through the kernels' fragment loaders (a test of
    the fragment layouts): q, k, v contiguous (16, 16) bfloat16 CUDA
    tensors; returns fp32 ``s = q k^T`` and ``o = bf16(s) v``."""
    for t in (q, k, v):
        if t.shape != (16, 16) or t.dtype != torch.bfloat16 \
                or t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError("mma_tile: q, k, v must be contiguous (16, 16) "
                             "bfloat16 CUDA tensors")
    s = torch.empty((16, 16), dtype=torch.float32, device=q.device)
    o = torch.empty_like(s)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = LIBRARY.load().flash_attention_mma_tile(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(),
            o.data_ptr(), stream)
    check_launch(err, "flash_attention_mma_tile")
    return s, o
