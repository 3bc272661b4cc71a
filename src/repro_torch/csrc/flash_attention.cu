// Grouped-query attention, forward, with an online softmax; hand-written
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_flash_kernel (entered through
// src/repro/kernels/ops.py::flash_attention).  For query row i of head h
// (absolute position q_offset + i) and the keys j its kv head h / (Hq/Hkv)
// may see:
//
//     s_j   = (q_i . k_j) * (1 / sqrt(d))             fp32
//     s_j   = -1e30 where the causal mask (q_offset + i >= j) fails
//     out_i = sum_j softmax(s)_j v_j                    fp32, cast to q's type
//
// with the fp32 running max m (from -1e30), denominator l and accumulator
// carried over key tiles, l clamped at 1e-30 at the end -- the TPU kernel's
// arithmetic.  On request each row's log-sum-exp m + log(l) is written
// beside the output (a decode over a cache split across ranks merges the
// ranks' partial outputs by it).  Keys at or beyond kv_len, and key tiles
// wholly above the causal diagonal of a block's last row, are never read:
// the reference gives them weight exp(-1e30 - m) = 0 exactly, because every
// row sees key 0 (the wrapper refuses kv_len < 1 and q_offset < 0), so
// skipping them changes nothing.  The finite -1e30 is kept (not -inf) so a
// masked score inside a read tile behaves as in the reference.
//
// Layout: q (B, Sq, Hq, d), k/v (B, Sk, Hkv, d) with any batch, sequence
// and head strides (the last dim contiguous), so the decode path reads the
// KV cache (B, S_max, Hkv, d) in place; the output is contiguous
// (B, Sq, Hq, d).  q_offset, kv_len, Sq and Sk are runtime values and
// ragged query and key tiles are masked here, so every shape runs a kernel
// (the TPU kernel needed static, block-divisible ones).
//
// What bounds it on an H100: at the main path's prefill (4 x 512 tokens,
// 16 query heads over 2 KV heads, d 128, bf16, causal) it must move about
// 19 MB (5.6 us at 3.35 TB/s) and do 4.3 GFLOP (4.4 us on the bf16 tensor
// cores); a decode step (Sq = 1 over ~530 cached keys) moves about 2.2 MB
// (0.65 us) and does almost no arithmetic.  Both are bound by bytes, so the
// bfloat16 designs keep 16-byte loads in flight and fill the SMs, and put
// the products on the tensor cores so that they stop being the limit:
//
// * Tile kernel (attn_mma_kernel<D, 1, false>; prefill and any call with
//   more than 64 query rows per KV head).  A block of 4 warps takes 64
//   query rows, 16 a warp, of one (batch, query head); the grid runs the
//   heaviest query tiles under the causal mask first.  K and V come in by
//   16-byte cp.async, in tiles of 64 keys, into a 2-stage ring in dynamic
//   shared memory (87,040 B at d 128), K and V as separate copy groups so
//   that QK^T starts while V is still in flight.  Rows are padded by 16
//   bytes, which makes every ldmatrix free of bank conflicts.  QK^T and PV
//   are mma.sync.m16n8k16 in bf16 with fp32 accumulators in registers; the
//   row max and sum take two quad shuffles; P goes from the score
//   accumulators straight into the bf16 A fragments of PV, never through
//   shared memory.  Masks are applied only on tiles that cross kv_len or
//   the diagonal.  The epilogue stages the bf16 rows in shared memory and
//   stores 16-byte chunks.
// * Split-KV decode (attn_mma_kernel<D, KW, true> + attn_merge_kernel<D>;
//   at most 64 query rows per KV head, Sq = 1 in the serving path).  One
//   block per (batch, KV head, key split) holds all group x Sq query rows
//   of that KV head, so each K/V row is read once per KV head, not once
//   per query head.  Its 4 warps load together.  Where the rows fit one
//   tile of 16 (KW = 4), the 4 warps split each 64-key tile between them,
//   16 keys a warp, and merge their partial softmaxes in shared memory, so
//   a group of 8 (one half-empty row tile) still computes on 4 warps; with
//   17..64 rows (KW = 1) each warp takes a row tile.  The host plans the
//   splits from the number of keys, B * Hkv and the SM count so that the
//   grid covers the card, with no empty split.  Each split writes fp32
//   partials (acc, m, l) to a scratch tensor the wrapper allocates; the
//   merge kernel weighs them by exp(m_s - m), clamps l at 1e-30 and
//   casts.  A decode call is two device kernels.
// * float32 (flash_fwd_f32): the first design, fp32 FMAs on the CUDA
//   cores, one block of 4 warps per (batch * query head, 16 query rows),
//   32-key tiles staged as fp32.  Only float32 calls take it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;              // the reference's NEG_INF

// ---------------------------------------------------------------------------
// float32: SIMT kernel
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 16;                    // query rows per block
constexpr int kRowsPerWarp = kBlockQ / kWarps;
constexpr int kBlockK = 32;                    // keys per tile, one a lane

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  const void* q;
  int64_t q_sb, q_ss, q_sh;
  const void* k;
  int64_t k_sb, k_ss, k_sh;
  const void* v;
  int64_t v_sb, v_ss, v_sh;
  void* o;
  float* part;    // decode: (B * Hkv, n_split, rows, D + 2) fp32 partials
  float* lse;     // optional (B, Sq, Hq) fp32: each row's m + log(l)
  int sq, hq, hkv, group;
  int key_limit;  // min(Sk, kv_len): keys at or past it are never read
  int causal, q_offset;
  int rows;       // decode: group * Sq query rows per KV head
  int n_split, split_keys;
  float scale;
};

// Lane j scores key j of the tile, the warp reduces max and sum with
// shuffles, and lane c accumulates output channels c, c + 32, ... of the
// row.  K rows are padded to d + 4 floats so each lane's float4 reads of
// its own key are free of bank conflicts.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(Args a) {
  constexpr int kCpl = (D + 31) / 32;          // output channels a lane
  constexpr int kKStride = D + 4;              // padded K row, 16 B aligned
  __shared__ __align__(16) float qs[kBlockQ][D];
  __shared__ __align__(16) float ks[kBlockK][kKStride];
  __shared__ float vs[kBlockK][D];

  const int bh = blockIdx.x;                   // b * Hq + h
  const int b = bh / a.hq;
  const int h = bh - b * a.hq;
  const int hk = h / a.group;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i - (i / D) * D;
    const int row = q0 + r;
    qs[r][c] = row < a.sq ? qp[row * a.q_ss + c] : 0.0f;
  }

  // keys this block reads: up to kv_len, and up to the causal diagonal of
  // its last real row
  int n_keys = a.key_limit;
  if (a.causal) n_keys = min(n_keys, a.q_offset + min(q0 + kBlockQ, a.sq));

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCpl];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.0f;
#pragma unroll
    for (int t = 0; t < kCpl; ++t) acc[rr][t] = 0.0f;
  }

  for (int k0 = 0; k0 < n_keys; k0 += kBlockK) {
    __syncthreads();                           // last tile consumed
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i - (i / D) * D;
      const int key = k0 + r;
      float kv = 0.0f, vv = 0.0f;
      if (key < n_keys) {
        kv = kp[key * a.k_ss + c];
        vv = vp[key * a.v_ss + c];
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    __syncthreads();
    const int nk = min(kBlockK, n_keys - k0);  // >= 1
    const bool in_tile = lane < nk;
    const int key = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      if (q0 + r >= a.sq) continue;            // warp-uniform
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < D; c += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(&qs[r][c]);
        const float4 kv = *reinterpret_cast<const float4*>(&ks[lane][c]);
        s = fmaf(qv.x, kv.x, s);
        s = fmaf(qv.y, kv.y, s);
        s = fmaf(qv.z, kv.z, s);
        s = fmaf(qv.w, kv.w, s);
      }
      s *= a.scale;
      if (a.causal && key > a.q_offset + q0 + r) s = kNegInf;
      const float m_new = fmaxf(m[rr], warp_max(in_tile ? s : -INFINITY));
      const float corr = expf(m[rr] - m_new);
      const float p = in_tile ? expf(s - m_new) : 0.0f;
      l[rr] = l[rr] * corr + warp_sum(p);
#pragma unroll
      for (int t = 0; t < kCpl; ++t) acc[rr][t] *= corr;
      for (int j = 0; j < nk; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int t = 0; t < kCpl; ++t) {
          const int c = lane + 32 * t;
          if (c < D) acc[rr][t] = fmaf(pj, vs[j][c], acc[rr][t]);
        }
      }
      m[rr] = m_new;
    }
  }

  float* op = static_cast<float*>(a.o);
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + warp * kRowsPerWarp + rr;
    if (row >= a.sq) continue;
    const float denom = fmaxf(l[rr], 1e-30f);
    const int64_t at = (static_cast<int64_t>(b) * a.sq + row) * a.hq + h;
    if (a.lse != nullptr && lane == 0) a.lse[at] = m[rr] + logf(denom);
    float* orow = op + at * D;
#pragma unroll
    for (int t = 0; t < kCpl; ++t) {
      const int c = lane + 32 * t;
      if (c < D) orow[c] = acc[rr][t] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core tiles
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTileRows = 64;                  // query rows a block holds
constexpr int kTileKeys = 64;                  // keys a tile
constexpr int kStages = 2;                     // K/V ring depth
constexpr int kMmaThreads = 128;

template <int D> struct Tile {
  static constexpr int kRow = D + 8;           // padded row, in bf16
  static constexpr int kQ = kTileRows * kRow;
  static constexpr int kKV = kTileKeys * kRow;
  static constexpr int kChunks = D / 8;        // 16-byte chunks a row
  static constexpr int kBytes = (kQ + 2 * kStages * kKV) * 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy; with valid false nothing is read and the 16 bytes are
// zero-filled (src-size 0), so rows past Sq, Sk or a split stay finite
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(const void* p,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col): bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in bits 0-15
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment layouts of m16n8k16, for lane = 4 g + c: A holds rows g and
// g + 8, columns 2c, 2c + 1 (a0, a1) and 2c + 8, 2c + 9 (a2, a3); B holds
// column g, rows 2c, 2c + 1 (b0) and 2c + 8, 2c + 9 (b1); the accumulator
// holds rows g (c0, c1) and g + 8 (c2, c3), columns 2c, 2c + 1.

// A fragment of 16 rows x 16 dims at (row0, k0) of a row-major tile
template <int kRow>
__device__ __forceinline__ void load_a(const bf16* t, int row0, int k0,
                                       int lane, uint32_t (&a)[4]) {
  ldsm_x4(t + (row0 + (lane & 15)) * kRow + k0 + (lane >> 4) * 8, a);
}

// B fragments of key blocks n0 .. n0 + 7 (b[0], b[1]) and n0 + 8 .. n0 + 15
// (b[2], b[3]) over dims k0 .. k0 + 15 of K, row-major (key, dim): S = QK^T
template <int kRow>
__device__ __forceinline__ void load_b_k(const bf16* t, int n0, int k0,
                                         int lane, uint32_t (&b)[4]) {
  ldsm_x4(t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * kRow + k0
              + ((lane >> 3) & 1) * 8, b);
}

// B fragments of dims n0 .. n0 + 7 (b[0], b[1]) and n0 + 8 .. n0 + 15
// (b[2], b[3]) over keys k0 .. k0 + 15 of V, row-major (key, dim): O = PV
template <int kRow>
__device__ __forceinline__ void load_b_v(const bf16* t, int k0, int n0,
                                         int lane, uint32_t (&b)[4]) {
  ldsm_x4_trans(t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kRow + n0
                    + (lane >> 4) * 8, b);
}

// The A fragment of P for keys 16 kk .. 16 kk + 15, from the score
// accumulators of key blocks 2 kk and 2 kk + 1
__device__ __forceinline__ void p_fragment(const float (&s0)[4],
                                           const float (&s1)[4],
                                           uint32_t (&a)[4]) {
  a[0] = pack_bf16(s0[0], s0[1]);
  a[1] = pack_bf16(s0[2], s0[3]);
  a[2] = pack_bf16(s1[0], s1[1]);
  a[3] = pack_bf16(s1[2], s1[3]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Copy keys k0 .. k0 + 63 of one kv head (rows at or past k_end
// zero-filled) into a padded tile.
template <int D>
__device__ __forceinline__ void load_kv_tile(bf16* dst, const bf16* src,
                                             int64_t stride, int k0,
                                             int k_end, int tid,
                                             int n_threads) {
  using T = Tile<D>;
  for (int i = tid; i < kTileKeys * T::kChunks; i += n_threads) {
    const int r = i / T::kChunks, c = i - r * T::kChunks;
    const bool valid = k0 + r < k_end;
    cp_async16(dst + r * T::kRow + c * 8,
               src + (valid ? (k0 + r) * stride : 0) + c * 8, valid);
  }
}

// kDecode false (KW = 1): block (b * Hq + h, query tile), 4 warps, 16 of
// the 64 rows of one query head a warp; writes the bf16 output.
// kDecode true: block (key split, b * Hkv + hk) over the group x Sq rows of
// one kv head (row r is query r / group of head hk * group + r % group),
// in 4 / KW tiles of 16 rows (KW is 4 or 1).  The KW warps of a row tile
// share its keys:
// warp kw takes keys [kw * 64 / KW, (kw + 1) * 64 / KW) of each 64-key
// tile, and their partial softmaxes are merged in shared memory; the block
// writes fp32 partials for attn_merge_kernel.
template <int D, int KW, bool kDecode>
__global__ void __launch_bounds__(kMmaThreads) attn_mma_kernel(Args a) {
  using T = Tile<D>;
  constexpr int kSlice = kTileKeys / KW;       // keys a warp takes a tile
  constexpr int kRowTiles = kMmaThreads / 32 / KW;
  static_assert(kDecode || KW == 1, "the tile kernel gives each warp rows");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + T::kQ;                       // [stage][key][kRow]
  bf16* vs = ks + kStages * T::kKV;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = warp / KW, kw = warp - mt * KW;   // row tile, key slice

  int b, hk, h = 0, q0 = 0, k_begin = 0, k_end, min_pos;
  if (kDecode) {
    b = blockIdx.y / a.hkv;
    hk = blockIdx.y - b * a.hkv;
    k_begin = blockIdx.x * a.split_keys;
    k_end = min(a.key_limit, k_begin + a.split_keys);
    if (a.causal) k_end = min(k_end, a.q_offset + a.sq);
    min_pos = a.q_offset;
  } else {
    b = blockIdx.x / a.hq;
    h = blockIdx.x - b * a.hq;
    hk = h / a.group;
    q0 = (gridDim.y - 1 - blockIdx.y) * kTileRows;   // heaviest tiles first
    k_end = a.key_limit;
    if (a.causal) k_end = min(k_end, a.q_offset + min(q0 + kTileRows, a.sq));
    min_pos = a.q_offset + q0;
  }
  // query row r of the block -> (sequence index, query head, real?)
  auto row_of = [&](int r, int& s, int& head) -> bool {
    if (kDecode) {
      s = r / a.group;
      head = hk * a.group + (r - s * a.group);
      return r < a.rows;
    }
    s = q0 + r;
    head = h;
    return s < a.sq;
  };

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;

  for (int i = tid; i < kRowTiles * 16 * T::kChunks; i += kMmaThreads) {
    const int r = i / T::kChunks, c = i - r * T::kChunks;
    int s, head;
    const bool valid = row_of(r, s, head);
    cp_async16(qs + r * T::kRow + c * 8,
               qb + (valid ? s * a.q_ss + head * a.q_sh : 0) + c * 8, valid);
  }
  cp_async_commit();
  const int n_tiles = (k_end - k_begin + kTileKeys - 1) / kTileKeys;
  load_kv_tile<D>(ks, kb, a.k_ss, k_begin, k_end, tid, kMmaThreads);
  cp_async_commit();
  load_kv_tile<D>(vs, vb, a.v_ss, k_begin, k_end, tid, kMmaThreads);
  cp_async_commit();

  // this lane's two rows, g and g + 8 of its row tile
  const int g = lane >> 2;
  int pos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int s, head;
    row_of(mt * 16 + g + 8 * i, s, head);
    pos[i] = a.q_offset + s;
  }

  cp_async_wait<2>();                          // Q landed
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    load_a<T::kRow>(qs, mt * 16, kk * 16, lane, qf[kk]);

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const int k0 = k_begin + t * kTileKeys;
    const bf16* kt = ks + st * T::kKV;
    const bf16* vt = vs + st * T::kKV;
    if (t + 1 < n_tiles) {                     // the next tile into the
      load_kv_tile<D>(ks + (st ^ 1) * T::kKV, kb, a.k_ss, k0 + kTileKeys,
                      k_end, tid, kMmaThreads);  // other stage
      cp_async_commit();
      load_kv_tile<D>(vs + (st ^ 1) * T::kKV, vb, a.v_ss, k0 + kTileKeys,
                      k_end, tid, kMmaThreads);
    } else {
      cp_async_commit();                       // empty groups keep the
    }                                          // count uniform
    cp_async_commit();
    cp_async_wait<3>();                        // K of tile t landed
    __syncthreads();

    // this warp's keys: [ks0, ks0 + kSlice); a decode warp whose keys all
    // lie past the split skips the tile (warp-uniform)
    const int ks0 = k0 + kw * kSlice;
    const bool active = !kDecode || ks0 < k_end;
    float s[kSlice / 8][4];
    float corr[2] = {1.0f, 1.0f};
    if (active) {
#pragma unroll
      for (int j = 0; j < kSlice / 8; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < kSlice / 8; j += 2) {
          uint32_t bk[4];
          load_b_k<T::kRow>(kt, kw * kSlice + j * 8, kk * 16, lane, bk);
          mma_16816(s[j], qf[kk], bk[0], bk[1]);
          mma_16816(s[j + 1], qf[kk], bk[2], bk[3]);
        }
      }

      const bool masked = ks0 + kSlice > k_end
          || (a.causal && ks0 + kSlice - 1 > min_pos);
      const int key0 = ks0 + 2 * (lane & 3);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kSlice / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * a.scale;
          if (masked) {
            const int key = key0 + j * 8 + (e & 1);
            if (key >= k_end || (a.causal && key > pos[e >> 1])) x = kNegInf;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = quad_max(mx[i]);
        corr[i] = __expf(m[i] - mx[i]);
        m[i] = mx[i];
      }
#pragma unroll
      for (int j = 0; j < kSlice / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = __expf(s[j][e] - mx[e >> 1]);
          rs[e >> 1] += s[j][e];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(rs[i]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
    }

    cp_async_wait<2>();                        // V of tile t landed
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kSlice / 16; ++kk) {
        uint32_t pa[4];
        p_fragment(s[2 * kk], s[2 * kk + 1], pa);
#pragma unroll
        for (int p = 0; p < D / 16; ++p) {
          uint32_t bv[4];
          load_b_v<T::kRow>(vt, kw * kSlice + kk * 16, p * 16, lane, bv);
          mma_16816(o[2 * p], pa, bv[0], bv[1]);
          mma_16816(o[2 * p + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();                           // stage st free for t + 2
  }

  const int c2 = 2 * (lane & 3);
  if (kDecode) {
    // every warp's (acc, m, l) into shared memory (Q and the K/V ring are
    // free), then the KW warps of each row tile merged into one partial a
    // row: per row the warps' weights exp(m_w - m), then the channels
    constexpr int kRed = D + 8;                // padded: no bank conflicts
    float* red = reinterpret_cast<float*>(smem);        // [warp][16][kRed]
    float* red_ml = red + kMmaThreads / 32 * 16 * kRed; // [warp][16][2]
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = g + 8 * i;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(red + (warp * 16 + r) * kRed + n * 8
                                   + c2) =
            make_float2(o[n][2 * i], o[n][2 * i + 1]);
      if ((lane & 3) == 0)
        *reinterpret_cast<float2*>(red_ml + (warp * 16 + r) * 2) =
            make_float2(m[i], l[i]);
    }
    __syncthreads();
    float* part = a.part
        + static_cast<int64_t>(blockIdx.y * a.n_split + blockIdx.x) * a.rows
          * (D + 2);
    if (tid < a.rows) {
      const int w0 = (tid >> 4) * KW, rr = tid & 15;
      float mm = kNegInf, ll = 0.0f;
#pragma unroll
      for (int w = w0; w < w0 + KW; ++w)
        mm = fmaxf(mm, red_ml[(w * 16 + rr) * 2]);
#pragma unroll
      for (int w = w0; w < w0 + KW; ++w) {
        float* ml = red_ml + (w * 16 + rr) * 2;
        ml[0] = __expf(ml[0] - mm);            // m -> the warp's weight
        ll = fmaf(ml[0], ml[1], ll);
      }
      *reinterpret_cast<float2*>(part + tid * (D + 2) + D) =
          make_float2(mm, ll);
    }
    __syncthreads();
    for (int i = tid; i < a.rows * D; i += kMmaThreads) {
      const int r = i / D, d = i - r * D;
      const int w0 = (r >> 4) * KW, rr = r & 15;
      float acc = 0.0f;
#pragma unroll
      for (int w = w0; w < w0 + KW; ++w)
        acc = fmaf(red_ml[(w * 16 + rr) * 2], red[(w * 16 + rr) * kRed + d],
                   acc);
      part[r * (D + 2) + d] = acc;
    }
    return;
  }

  // stage this warp's 16 bf16 rows in its own rows of qs (only this warp
  // read them, into qf), then store 16-byte chunks
  bf16* ow = qs + warp * 16 * T::kRow;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    const int s = q0 + warp * 16 + g + 8 * i;
    if (a.lse != nullptr && (lane & 3) == 0 && s < a.sq)
      a.lse[(static_cast<int64_t>(b) * a.sq + s) * a.hq + h] =
          m[i] + logf(fmaxf(l[i], 1e-30f));
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(ow + (g + 8 * i) * T::kRow + n * 8 + c2) =
          pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
  __syncwarp();
  bf16* out = static_cast<bf16*>(a.o);
  for (int i = lane; i < 16 * T::kChunks; i += 32) {
    const int r = i / T::kChunks, c = i - r * T::kChunks;
    const int s = q0 + warp * 16 + r;
    if (s >= a.sq) continue;
    *reinterpret_cast<uint4*>(
        out + ((static_cast<int64_t>(b) * a.sq + s) * a.hq + h) * D + c * 8) =
        *reinterpret_cast<const uint4*>(ow + r * T::kRow + c * 8);
  }
}

// block (b * Hkv + hk, row), thread = output channel: merge the splits'
// partials of one query row, kMergeBatch splits at a time.  Each batch
// issues all its loads (m, l and the channel's acc of every split) before
// it uses any, so a call with up to kMergeBatch splits waits for one
// round trip to L2; the batches merge online, as the softmax does.
constexpr int kMergeBatch = 16;

template <int D>
__global__ void __launch_bounds__(D) attn_merge_kernel(Args a) {
  const int bh = blockIdx.x, r = blockIdx.y, d = threadIdx.x;
  const int64_t split_stride = static_cast<int64_t>(a.rows) * (D + 2);
  const float* p = a.part
      + (static_cast<int64_t>(bh) * a.n_split * a.rows + r) * (D + 2);
  float m = kNegInf, l = 0.0f, acc = 0.0f;
  for (int s0 = 0; s0 < a.n_split; s0 += kMergeBatch) {
    float ms[kMergeBatch], ls[kMergeBatch], xs[kMergeBatch];
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) {
      const bool in = s0 + u < a.n_split;
      const float* ps = p + (in ? (s0 + u) * split_stride : 0);
      ms[u] = in ? ps[D] : -INFINITY;          // weight 0 past the splits
      ls[u] = in ? ps[D + 1] : 0.0f;
      xs[u] = in ? ps[d] : 0.0f;
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) m_new = fmaxf(m_new, ms[u]);
    const float corr = __expf(m - m_new);
    l *= corr;
    acc *= corr;
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) {
      const float w = __expf(ms[u] - m_new);
      l = fmaf(w, ls[u], l);
      acc = fmaf(w, xs[u], acc);
    }
    m = m_new;
  }
  const int b = bh / a.hkv, hk = bh - b * a.hkv;
  const int s = r / a.group;
  const int h = hk * a.group + (r - s * a.group);
  const int64_t at = (static_cast<int64_t>(b) * a.sq + s) * a.hq + h;
  static_cast<bf16*>(a.o)[at * D + d] =
      __float2bfloat16(acc / fmaxf(l, 1e-30f));
  if (a.lse != nullptr && d == 0) a.lse[at] = m + logf(fmaxf(l, 1e-30f));
}

// One warp, one tile, through the same fragment loaders as the kernels:
// s = q k^T (16 x 16 x 16) and o = bf16(s) v (16 x 16 x 16), fp32 out.
__global__ void mma_tile_kernel(const bf16* q, const bf16* k, const bf16* v,
                                float* s_out, float* o_out) {
  constexpr int kRow = 24;
  __shared__ __align__(16) bf16 qs[16 * kRow], ks[16 * kRow], vs[16 * kRow];
  const int lane = threadIdx.x, r = lane >> 1, c = (lane & 1) * 8;
  *reinterpret_cast<uint4*>(qs + r * kRow + c) =
      *reinterpret_cast<const uint4*>(q + r * 16 + c);
  *reinterpret_cast<uint4*>(ks + r * kRow + c) =
      *reinterpret_cast<const uint4*>(k + r * 16 + c);
  *reinterpret_cast<uint4*>(vs + r * kRow + c) =
      *reinterpret_cast<const uint4*>(v + r * 16 + c);
  __syncwarp();
  uint32_t a[4], b[4];
  load_a<kRow>(qs, 0, 0, lane, a);
  load_b_k<kRow>(ks, 0, 0, lane, b);
  float s[2][4] = {}, o[2][4] = {};
  mma_16816(s[0], a, b[0], b[1]);
  mma_16816(s[1], a, b[2], b[3]);
  p_fragment(s[0], s[1], a);
  load_b_v<kRow>(vs, 0, 0, lane, b);
  mma_16816(o[0], a, b[0], b[1]);
  mma_16816(o[1], a, b[2], b[3]);
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  for (int j = 0; j < 2; ++j)
    for (int e = 0; e < 4; ++e) {
      const int idx = (g + 8 * (e >> 1)) * 16 + j * 8 + c2 + (e & 1);
      s_out[idx] = s[j][e];
      o_out[idx] = o[j][e];
    }
}

template <int D>
int launch_f32(const Args& a, int batch, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(batch * a.hq),
                  static_cast<unsigned int>((a.sq + kBlockQ - 1) / kBlockQ));
  flash_fwd_f32<D><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Raise the kernel's dynamic shared memory limit, then launch it.
template <typename Kernel>
int launch_mma(Kernel kernel, dim3 grid, int smem, const Args& a,
               cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kMmaThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const Args& a, int batch, cudaStream_t stream) {
  constexpr int smem = Tile<D>::kBytes;
  if (a.n_split == 0) {
    const dim3 grid(static_cast<unsigned int>(batch * a.hq),
                    static_cast<unsigned int>((a.sq + kTileRows - 1)
                                              / kTileRows));
    return launch_mma(attn_mma_kernel<D, 1, false>, grid, smem, a, stream);
  }
  // split-KV decode: 4 warps on one row tile up to 16 rows, else a row
  // tile a warp; then the merge
  const dim3 grid(a.n_split, batch * a.hkv);
  const int err =
      a.rows <= 16 ? launch_mma(attn_mma_kernel<D, 4, true>, grid, smem, a,
                                stream)
      : launch_mma(attn_mma_kernel<D, 1, true>, grid, smem, a, stream);
  if (err != 0) return err;
  attn_merge_kernel<D><<<dim3(batch * a.hkv, a.rows), D, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const Args& a, int batch, int is_bf16, cudaStream_t stream) {
  return is_bf16 ? launch_bf16<D>(a, batch, stream)
                 : launch_f32<D>(a, batch, stream);
}

}  // namespace

// Plain-C entry point for ctypes.  Pointers are device pointers, strides
// are in elements, `stream` is a cudaStream_t passed as an integer and
// kv_len < 0 means no length mask.  For bfloat16, n_split > 0 takes the
// split-KV decode path with splits of split_keys keys over `part`, an fp32
// scratch of B * Hkv * n_split * (Sq * Hq / Hkv) * (head_dim + 2) floats;
// n_split = 0 takes the tile kernel.  `lse`, when not null, receives each
// query row's log-sum-exp of its visible scaled scores, m + log(l), as a
// contiguous (B, Sq, Hq) fp32 tensor (the weight by which partial
// attentions over disjoint key blocks are merged).  Returns
// cudaGetLastError() after the launches (0 on success); the caller raises
// on anything else.
extern "C" int flash_attention_launch(
    const void* q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    const void* k, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    const void* v, int64_t v_sb, int64_t v_ss, int64_t v_sh, void* o,
    void* part, void* lse, int batch, int sq, int sk, int hq, int hkv,
    int head_dim, int causal, int q_offset, int kv_len, int is_bf16,
    int n_split, int split_keys, void* stream) {
  Args a;
  a.q = q; a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k = k; a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v = v; a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.o = o;
  a.part = static_cast<float*>(part);
  a.lse = static_cast<float*>(lse);
  a.sq = sq;
  a.hq = hq;
  a.hkv = hkv;
  a.group = hq / hkv;
  a.key_limit = (kv_len < 0 || kv_len > sk) ? sk : kv_len;
  a.causal = causal;
  a.q_offset = q_offset;
  a.rows = sq * a.group;
  a.n_split = n_split;
  a.split_keys = split_keys;
  a.scale = 1.0f / sqrtf(static_cast<float>(head_dim));
  if (n_split > 0 && (!is_bf16 || a.rows > kTileRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(a, batch, is_bf16, s);
    case 32: return launch<32>(a, batch, is_bf16, s);
    case 64: return launch<64>(a, batch, is_bf16, s);
    case 128: return launch<128>(a, batch, is_bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Test entry: one m16n8k16 tile through the kernels' fragment loaders.
// q, k, v: 16 x 16 bf16, row-major; s_out = q k^T and o_out = bf16(s) v,
// 16 x 16 fp32.
extern "C" int flash_attention_mma_tile(const void* q, const void* k,
                                        const void* v, void* s_out,
                                        void* o_out, void* stream) {
  mma_tile_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<float*>(s_out),
      static_cast<float*>(o_out));
  return static_cast<int>(cudaGetLastError());
}
