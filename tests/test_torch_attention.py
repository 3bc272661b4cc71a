"""GQA attention of the PyTorch port against the JAX reference and its kernel.

The port's plain version (``repro_torch.kernels.ref.attention_ref``, the
CPU path of ``ops.flash_attention``) is held against the JAX reference
``ref.attention_ref`` and against the Pallas kernel in interpret mode on
the same numpy inputs, with the tolerances of ``tests/test_kernels.py``:
2e-5 in float32 (another summation order), 2e-2 in bfloat16 (the output
is rounded to bf16).  The CUDA kernel is held against the port's plain
version on the card (marked ``gpu``), at the same shapes and at the
ragged and decode shapes the JAX ``ops`` sent to its reference.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_ref

torch.set_num_threads(1)

#: the ATTN_CASES of tests/test_kernels.py: (B, Sq, Sk, Hq, Hkv, d, causal)
ATTN_CASES = [
    (1, 128, 128, 4, 4, 64, True),      # MHA
    (2, 256, 256, 4, 2, 64, True),      # GQA 2:1
    (1, 256, 256, 8, 1, 128, True),     # MQA
    (2, 128, 128, 4, 2, 128, False),    # bidirectional (encoder)
    (1, 384, 384, 2, 2, 64, True),      # non-power-of-two blocks (3 blocks)
]
#: shapes whose tiles do not divide, which the JAX ops ran through its
#: reference: (B, Sq, Sk, Hq, Hkv, d, causal, q_offset, kv_len)
RAGGED_CASES = [
    (1, 200, 200, 4, 2, 64, True, 0, None),
    (2, 100, 300, 4, 2, 32, True, 200, None),
    (1, 37, 53, 2, 1, 16, False, 0, 41),
    (2, 1, 40, 4, 2, 64, False, 0, 29),   # decode: Sq = 1 over a cache
]
DTYPES = {"float32": (np.float32, torch.float32, 2e-5),
          "bfloat16": (None, torch.bfloat16, 2e-2)}


@pytest.fixture(scope="module")
def jax_attention():
    jax = pytest.importorskip("jax")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return jax, jops, jref


def _inputs(B, Sq, Sk, Hq, Hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, d), (B, Sk, Hkv, d), (B, Sk, Hkv, d))]


def _to_jax(jax, arrays, dtype):
    return [jax.numpy.asarray(a, getattr(jax.numpy, dtype)) for a in arrays]


def _to_torch(arrays, dtype):
    return [torch.as_tensor(a).to(DTYPES[dtype][1]) for a in arrays]


def _assert_close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_jax_ref_and_pallas(jax_attention, case, dtype):
    jax, jops, jref = jax_attention
    B, Sq, Sk, Hq, Hkv, d, causal = case
    arrays = _inputs(B, Sq, Sk, Hq, Hkv, d)
    tol = DTYPES[dtype][2]
    got = ops.flash_attention(*_to_torch(arrays, dtype), causal=causal)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, Sq, Hq, d)
    jq, jk, jv = _to_jax(jax, arrays, dtype)
    _assert_close(got, jref.attention_ref(jq, jk, jv, causal=causal), tol)
    _assert_close(got, jops.flash_attention(jq, jk, jv, causal=causal,
                                            impl="pallas_interpret"), tol)


@pytest.mark.parametrize("kw,shape", [
    ({"causal": False, "kv_len": 57}, (1, 128, 128, 2, 2, 64)),
    ({"causal": True, "q_offset": 128}, (1, 128, 256, 2, 2, 64)),
])
def test_kv_len_and_q_offset_match_pallas(jax_attention, kw, shape):
    """The kv_len mask and a query block placed mid-sequence (the cases of
    tests/test_kernels.py)."""
    jax, jops, _ = jax_attention
    arrays = _inputs(*shape, seed=4)
    got = ops.flash_attention(*_to_torch(arrays, "float32"), **kw)
    want = jops.flash_attention(*_to_jax(jax, arrays, "float32"),
                                impl="pallas_interpret", **kw)
    _assert_close(got, want, 2e-5)


@pytest.mark.parametrize("case", RAGGED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_and_decode_match_jax(jax_attention, case, dtype):
    """Shapes the JAX ops sent to its reference, decode (Sq = 1 with
    ``kv_len``) among them: the port answers the same."""
    jax, jops, _ = jax_attention
    B, Sq, Sk, Hq, Hkv, d, causal, q_offset, kv_len = case
    arrays = _inputs(B, Sq, Sk, Hq, Hkv, d, seed=7)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    got = ops.flash_attention(*_to_torch(arrays, dtype), **kw)
    want = jops.flash_attention(*_to_jax(jax, arrays, dtype),
                                impl="pallas_interpret", **kw)
    _assert_close(got, want, DTYPES[dtype][2])


def test_q_block_path_equals_direct():
    arrays = _to_torch(_inputs(2, 512, 512, 4, 4, 64, seed=10), "float32")
    direct = attention_ref(*arrays, causal=True)
    blocked = attention_ref(*arrays, causal=True, q_block=128)
    _assert_close(blocked, direct.numpy(), 1e-5)


def test_fully_masked_row_is_uniform_as_in_jax(jax_attention):
    """The finite -1e30 mask: a row with no visible key averages all
    keys in both plain versions (the port's ops refuses to get there)."""
    jax, _, jref = jax_attention
    arrays = _inputs(1, 4, 8, 2, 2, 16, seed=3)
    got = attention_ref(*_to_torch(arrays, "float32"), causal=False,
                        kv_len=0)
    want = jref.attention_ref(*_to_jax(jax, arrays, "float32"),
                              causal=False, kv_len=0)
    _assert_close(got, want, 2e-5)
    _assert_close(got, np.broadcast_to(arrays[2].mean(1, keepdims=True),
                                       (1, 4, 2, 16)), 2e-5)


def test_refusals():
    q, k, v = _to_torch(_inputs(1, 4, 8, 2, 2, 16), "float32")
    with pytest.raises(ValueError, match="impl='ref'"):
        ops.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError, match="kv_len 0 < 1"):
        ops.flash_attention(q, k, v, kv_len=0)
    with pytest.raises(ValueError, match="q_offset -1"):
        ops.flash_attention(q, k, v, q_offset=-1)
    q48, k48, v48 = _to_torch(_inputs(1, 4, 8, 2, 2, 48), "float32")
    with pytest.raises(ValueError, match="head dim 48"):
        fa.flash_attention_cuda(q48, k48, v48)
    with pytest.raises(ValueError, match="not a CUDA device"):
        fa.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="multiple of"):
        fa.flash_attention_cuda(q[:, :, :1].repeat(1, 1, 3, 1), k, v)
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_attention_cuda(q.half(), k.half(), v.half())


def test_kernel_library_named_by_source_hash():
    path = fa.LIBRARY.library_path()
    assert path.parent.name == "repro_torch"
    assert path.name.startswith("flash_attention_") and path.suffix == ".so"


@pytest.mark.gpu
@pytest.mark.parametrize("case", [c + (0, None) for c in ATTN_CASES]
                         + RAGGED_CASES
                         + [(4, 512, 512, 16, 2, 128, True, 0, None),
                            (4, 1, 544, 16, 2, 128, False, 0, 513)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_ref(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, Sq, Sk, Hq, Hkv, d, causal, q_offset, kv_len = case
    q, k, v = (t.cuda() for t in _to_torch(
        _inputs(B, Sq, Sk, Hq, Hkv, d, seed=5), dtype))
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    before = fa.LAUNCHES
    got = ops.flash_attention(q, k, v, **kw)
    assert fa.LAUNCHES == before + 1
    want = attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_close(got.cpu(), want.float().cpu().numpy(), DTYPES[dtype][2])
