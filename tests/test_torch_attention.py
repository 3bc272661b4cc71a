"""GQA attention of the PyTorch port against the JAX reference and its kernel.

The port's plain version (``repro_torch.kernels.ref.attention_ref``, the
CPU path of ``ops.flash_attention``) is held against the JAX reference
``ref.attention_ref`` and against the Pallas kernel in interpret mode on
the same numpy inputs, with the tolerances of ``tests/test_kernels.py``:
2e-5 in float32 (another summation order), 2e-2 in bfloat16 (the output
is rounded to bf16).  The CUDA kernel is held against the port's plain
version on the card (marked ``gpu``), at the same shapes and at the
ragged and decode shapes the JAX ``ops`` sent to its reference; the
bfloat16 tile and split-KV decode kernels also at every decode kv_len,
group sizes 1, 8 and 48, every head dim, cache views and inputs scaled
like the serving path's, and one m16n8k16 tile against ``torch.matmul``.
On the CPU run the wrapper's layout refusals and the decode split plan.
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


#: (B, Sq, Sk, Hq, Hkv, d, causal, q_offset, kv_len) for the row
#: log-sum-exp: the decode route (split keys), the prefill tiles, a
#: ragged offset and a length mask
LSE_CASES = [(2, 1, 544, 16, 2, 128, False, 0, 300),
             (2, 1, 544, 48, 1, 64, False, 0, 17),
             (2, 70, 150, 8, 2, 64, True, 80, None),
             (1, 130, 130, 16, 2, 128, True, 0, None),
             (3, 8, 57, 16, 2, 32, True, 49, 50)]


def _lse_want(q, k, causal, q_offset, kv_len):
    """Each query row's log-sum-exp of its scaled, masked scores,
    computed apart from the attention code."""
    B, Sq, Hq, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, Hkv, Hq // Hkv, d)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.float()) / np.sqrt(d)
    keep = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        keep &= torch.arange(Sk)[None] <= q_offset + torch.arange(Sq)[:, None]
    if kv_len is not None:
        keep &= torch.arange(Sk)[None] < kv_len
    s = s.masked_fill(~keep[None, :, None, None, :], -np.inf)
    return torch.logsumexp(s, -1).reshape(B, Sq, Hq)


@pytest.mark.parametrize("case", LSE_CASES)
def test_lse_is_each_rows_logsumexp(case):
    """``return_lse`` on the plain path: the attention output unchanged,
    and the rows' log-sum-exp of their visible scores."""
    B, Sq, Sk, Hq, Hkv, d, causal, q_offset, kv_len = case
    q, k, v = _to_torch(_inputs(B, Sq, Sk, Hq, Hkv, d, seed=6), "float32")
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, ops.flash_attention(q, k, v, **kw))
    assert lse.dtype == torch.float32 and lse.shape == (B, Sq, Hq)
    torch.testing.assert_close(lse, _lse_want(q, k, causal, q_offset,
                                              kv_len), rtol=1e-6, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("case", LSE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_lse_matches_ref(case, dtype):
    """The row log-sum-exp the kernels write beside the output, on every
    route, against the plain version's, from the same one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, Sq, Sk, Hq, Hkv, d, causal, q_offset, kv_len = case
    q, k, v = (t.cuda() for t in _to_torch(
        _inputs(B, Sq, Sk, Hq, Hkv, d, seed=6), dtype))
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    before = fa.LAUNCHES
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    assert fa.LAUNCHES == before + 1
    want_out, want = attention_ref(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    _assert_close(out.cpu(), want_out.float().cpu().numpy(),
                  DTYPES[dtype][2])
    assert float(((lse - want).abs() / (1 + want.abs())).max()) <= 1e-4


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


@pytest.mark.parametrize("n_heads", [1, 8, 48, 200])
def test_decode_splits_cover_every_key_once(n_heads):
    """Every kv_len 1..4096: >= 1 split, no empty one, and the splits
    [i * keys, min((i + 1) * keys, n)) tile [0, n) exactly."""
    for n in range(1, 4097):
        n_split, keys = fa.plan_decode_splits(n, n_heads, 132)
        assert n_split >= 1 and keys % fa.SPLIT_KEY_MULTIPLE == 0
        starts = [i * keys for i in range(n_split)]
        ends = [min(s + keys, n) for s in starts]
        assert starts[0] == 0 and ends[-1] == n
        assert all(e > s for s, e in zip(starts, ends))
        assert all(a == b for a, b in zip(ends[:-1], starts[1:]))


def test_decode_splits_fill_the_card():
    """At the serving shape (B * Hkv = 8, ~530 keys) the grid covers the
    132 SMs; with as many heads as SMs one split is enough."""
    n_split, keys = fa.plan_decode_splits(528, 8, 132)
    assert 8 * n_split >= 128 and (n_split, keys) == (17, 32)
    assert fa.plan_decode_splits(4096, 132, 132) == (1, 4096)
    with pytest.raises(ValueError, match="n_keys 0"):
        fa.plan_decode_splits(0, 8, 132)


def _bf16_qkv():
    q = torch.zeros((2, 8, 4, 64), dtype=torch.bfloat16)
    cache = torch.zeros((2, 40, 2, 64), dtype=torch.bfloat16)
    return q, cache


@pytest.mark.parametrize("what", ["pointer", "sequence stride",
                                  "head stride", "batch stride"])
def test_layout_refuses_unaligned_bf16(what):
    """The bfloat16 kernels load 16-byte chunks: a view whose rows do not
    start on 16 bytes is refused, never given to the plain version."""
    q, cache = _bf16_qkv()
    k = v = cache
    if what == "pointer":
        k = cache.flatten()[4:4 + 2 * 39 * 2 * 64].view(2, 39, 2, 64)
    elif what == "sequence stride":
        k = torch.zeros((2, 40, 2 * 64 + 4),
                        dtype=torch.bfloat16)[..., :128].view(2, 40, 2, 64)
    elif what == "head stride":
        q = torch.zeros((2, 8, 4, 68), dtype=torch.bfloat16)[..., :64]
    else:
        v = torch.zeros((2 * 40 * 2 * 64 + 4),
                        dtype=torch.bfloat16)[:2 * 40 * 2 * 64].as_strided(
            (2, 40, 2, 64), (40 * 2 * 64 + 4, 128, 64, 1))
    match = "16-byte aligned" if what == "pointer" else "multiples of 8"
    with pytest.raises(ValueError, match=match):
        fa.check_layout(q, k, v)


def test_layout_takes_cache_views_and_float32():
    """A KV-cache view at any ``pos`` keeps 16-byte rows; the stride of a
    size-1 dim is never used; float32 is not held to 16 bytes."""
    q, cache = _bf16_qkv()
    for pos in (0, 1, 17):
        fa.check_layout(q[:, :1], cache[:, pos:pos + 9], cache[:, pos:])
    odd = torch.zeros((1, 1, 3, 64), dtype=torch.bfloat16).as_strided(
        (1, 1, 2, 64), (7, 5, 64, 1))
    fa.check_layout(odd, cache, cache)
    f = torch.zeros((1, 5, 3, 17), dtype=torch.float32)[..., 1:]
    fa.check_layout(f, f, f)
    with pytest.raises(ValueError, match="contiguous"):
        fa.check_layout(q.transpose(2, 3), cache, cache)


def test_grid_limit_only_on_the_decode_route():
    """B * Hkv lies on grid.y only in the split-KV decode: a bf16 decode
    call past 65,535 is refused, the same heads through the tile or the
    float32 kernel are not.  (Stride-0 views: only shapes are read.)"""
    def qkv(dtype, sq):
        return (torch.zeros((), dtype=dtype).expand(65536, sq, 1, 16),
                torch.zeros((), dtype=dtype).expand(65536, 4, 1, 16))
    q, k = qkv(torch.bfloat16, 1)
    assert fa.takes_decode(q, k)
    with pytest.raises(ValueError, match="B \\* Hkv 65536"):
        fa.check_args(q, k, k, 0, None)
    for dtype, sq in ((torch.bfloat16, fa.DECODE_MAX_ROWS + 1),
                      (torch.float32, 1)):
        q, k = qkv(dtype, sq)
        assert not fa.takes_decode(q, k)
        fa.check_args(q, k, k, 0, None)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _serving_scale(B, Sq, Sk, Hq, Hkv, d, seed):
    """q x 11, k x 32: the spreads of the zoo's random-weight attention
    (PERF.md section 2), which make the softmax nearly one-hot."""
    q, k, v = _to_torch(_inputs(B, Sq, Sk, Hq, Hkv, d, seed=seed),
                        "bfloat16")
    return (q.float() * 11).bfloat16().cuda(), \
        (k.float() * 32).bfloat16().cuda(), v.cuda()


def _check_cuda(q, k, v, **kw):
    before = fa.LAUNCHES
    got = fa.flash_attention_cuda(q, k, v, **kw)
    assert fa.LAUNCHES == before + 1
    want = attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_close(got.cpu(), want.float().cpu().numpy(),
                  DTYPES["bfloat16" if q.dtype == torch.bfloat16
                         else "float32"][2])


@pytest.mark.gpu
def test_cuda_mma_tile_matches_matmul():
    """One m16n8k16 tile through the kernels' fragment loaders: QK^T and
    bf16(S) V against torch.matmul in fp32."""
    _cuda_or_skip()
    q, k, v = (t.cuda() for t in _to_torch(
        [a[0, :, 0] for a in _inputs(1, 16, 16, 1, 1, 16, seed=9)],
        "bfloat16"))
    s, o = fa.mma_tile(q, k, v)
    want_s = q.float() @ k.float().T
    want_o = s.bfloat16().float() @ v.float()
    torch.cuda.synchronize()
    _assert_close(s.cpu(), want_s.cpu().numpy(), 1e-5)
    _assert_close(o.cpu(), want_o.cpu().numpy(), 1e-5)


#: decode kv_lens: 1..80, and 16-key split boundaries and their
#: neighbours up to a 544-slot cache
DECODE_KV_LENS = sorted(set(range(1, 81)) | {
    n + e for n in range(96, 545, 16) for e in (-1, 0, 1) if n + e <= 544})


@pytest.mark.gpu
@pytest.mark.parametrize("group,d", [(1, 64), (8, 128), (48, 128), (8, 16),
                                     (8, 32), (8, 64)])
def test_cuda_decode_every_kv_len(group, d):
    """The split-KV decode kernel over a 544-slot cache at every kv_len
    of DECODE_KV_LENS, for group sizes 1, 8 and 48 and each head dim."""
    _cuda_or_skip()
    q, kc, vc = (t.cuda() for t in _to_torch(
        _inputs(2, 1, 544, 2 * group, 2, d, seed=11), "bfloat16"))
    for n in DECODE_KV_LENS:
        _check_cuda(q, kc, vc, causal=False, kv_len=n)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    (2, 70, 150, 8, 2, 64, True, 80),      # q_offset, ragged Sq and Sk
    (1, 9, 100, 16, 2, 64, True, 91),      # 72 rows per kv head: tiles
    (3, 8, 57, 16, 2, 32, True, 49),       # 64 rows per kv head: decode
    (2, 3, 60, 16, 2, 64, True, 50),       # 24 rows: decode, a tile a warp
    (1, 130, 130, 48, 1, 128, True, 0),    # group 48 prefill
])
def test_cuda_offsets_and_cache_views(case):
    """q_offset > 0 with ragged Sq and Sk, reading K/V as views of a
    larger cache sliced at a nonzero ``pos``."""
    _cuda_or_skip()
    B, Sq, Sk, Hq, Hkv, d, causal, q_offset = case
    q, kc, vc = (t.cuda() for t in _to_torch(
        _inputs(B, Sq, Sk + 40, Hq, Hkv, d, seed=12), "bfloat16"))
    for pos in (0, 13, 40):
        _check_cuda(q, kc[:, pos:pos + Sk], vc[:, pos:pos + Sk],
                    causal=causal, q_offset=q_offset)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kw", [
    ((4, 512, 512, 16, 2, 128), dict(causal=True)),
    ((4, 1, 544, 16, 2, 128), dict(causal=False, kv_len=528)),
    ((2, 1, 544, 48, 1, 128), dict(causal=False, kv_len=300)),
    ((2, 200, 200, 32, 32, 64), dict(causal=True)),
])
def test_cuda_serving_scale_inputs(shape, kw):
    """Scores in the hundreds (near one-hot softmax): bf16 P must not turn
    a row into NaN or 0/0."""
    _cuda_or_skip()
    _check_cuda(*_serving_scale(*shape, seed=13), **kw)
