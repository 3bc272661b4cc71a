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
// arithmetic.  Keys at or beyond kv_len, and key tiles wholly above the
// causal diagonal of the block's last row, are never read: the reference
// gives them weight exp(-1e30 - m) = 0 exactly, because every row sees key
// 0 (the wrapper refuses kv_len < 1 and q_offset < 0), so skipping them
// changes nothing.  The finite -1e30 is kept (not -inf) so a masked score
// inside a read tile behaves as in the reference.
//
// Layout: q (B, Sq, Hq, d), k/v (B, Sk, Hkv, d) with any batch, sequence
// and head strides (the last dim contiguous), so the decode path reads the
// KV cache (B, S_max, Hkv, d) in place; the output is contiguous
// (B, Sq, Hq, d).  q_offset, kv_len, Sq and Sk are runtime values and the
// ragged last query and key tiles are masked here, so every shape runs
// this kernel (the TPU kernel needed static, block-divisible ones).
//
// What bounds it on an H100: at the main path's prefill (4 x 512 tokens,
// 16 query heads over 2 KV heads, d 128, bf16, causal) it must move about
// 19 MB (5.6 us at 3.35 TB/s) and do 4.3 GFLOP (4.4 us on the bf16 tensor
// cores), so bytes bound it; a decode step (Sq = 1 over ~530 cached keys)
// moves about 2.2 MB (0.65 us).  This first version is simple rather than
// fast: fp32 FMAs on the CUDA cores, no tensor cores, so it is bound by
// issue rate, not by either limit.  Its design: one block of 4 warps per
// (batch * query head, tile of 16 query rows), 4 rows a warp; a loop over
// tiles of 32 keys staged in shared memory as fp32 (K rows padded to
// d + 4 floats so each lane's float4 reads of its own key are free of bank
// conflicts); lane j scores key j of the tile, the warp reduces max and
// sum with shuffles, and lane c accumulates output channels c, c + 32, ...
// of the row.  GQA costs no copies: the block reads its kv head in place.
// Decode (Sq = 1) gives only B * Hq blocks with one busy warp each; wgmma,
// TMA and a split over keys are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 16;                    // query rows per block
constexpr int kRowsPerWarp = kBlockQ / kWarps;
constexpr int kBlockK = 32;                    // keys per tile, one a lane
constexpr float kNegInf = -1e30f;              // the reference's NEG_INF

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);                  // round to nearest even
}

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
  int sq, hq, group;
  int key_limit;  // min(Sk, kv_len): keys at or past it are never read
  int causal, q_offset;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
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

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i - (i / D) * D;
    const int row = q0 + r;
    qs[r][c] = row < a.sq ? to_float(qp[row * a.q_ss + c]) : 0.0f;
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
        kv = to_float(kp[key * a.k_ss + c]);
        vv = to_float(vp[key * a.v_ss + c]);
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

  T* op = static_cast<T*>(a.o);
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + warp * kRowsPerWarp + rr;
    if (row >= a.sq) continue;
    const float denom = fmaxf(l[rr], 1e-30f);
    T* orow = op + ((static_cast<int64_t>(b) * a.sq + row) * a.hq + h) * D;
#pragma unroll
    for (int t = 0; t < kCpl; ++t) {
      const int c = lane + 32 * t;
      if (c < D) orow[c] = from_float<T>(acc[rr][t] / denom);
    }
  }
}

template <typename T>
int launch_typed(const Args& a, int batch, int head_dim,
                 cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(batch * a.hq),
                  static_cast<unsigned int>((a.sq + kBlockQ - 1) / kBlockQ));
  switch (head_dim) {
    case 16: flash_fwd_kernel<T, 16><<<grid, kThreads, 0, stream>>>(a); break;
    case 32: flash_fwd_kernel<T, 32><<<grid, kThreads, 0, stream>>>(a); break;
    case 64: flash_fwd_kernel<T, 64><<<grid, kThreads, 0, stream>>>(a); break;
    case 128:
      flash_fwd_kernel<T, 128><<<grid, kThreads, 0, stream>>>(a);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain-C entry point for ctypes.  Pointers are device pointers, strides
// are in elements, `stream` is a cudaStream_t passed as an integer and
// kv_len < 0 means no length mask.  Returns cudaGetLastError() after the
// launch (0 on success); the caller raises on anything else.
extern "C" int flash_attention_launch(
    const void* q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    const void* k, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    const void* v, int64_t v_sb, int64_t v_ss, int64_t v_sh, void* o,
    int batch, int sq, int sk, int hq, int hkv, int head_dim, int causal,
    int q_offset, int kv_len, int is_bf16, void* stream) {
  Args a;
  a.q = q; a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k = k; a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v = v; a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.o = o;
  a.sq = sq;
  a.hq = hq;
  a.group = hq / hkv;
  a.key_limit = (kv_len < 0 || kv_len > sk) ? sk : kv_len;
  a.causal = causal;
  a.q_offset = q_offset;
  a.scale = 1.0f / sqrtf(static_cast<float>(head_dim));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_typed<__nv_bfloat16>(a, batch, head_dim, s)
                 : launch_typed<float>(a, batch, head_dim, s);
}
