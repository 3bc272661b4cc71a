// Mamba-1 selective scan, forward; hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/mamba_scan.py::_mamba_kernel (entered through
// src/repro/kernels/ops.py::selective_scan).  For each batch b and channel
// c of d_inner, from the state h0[b, c, :]:
//
//     h_t = exp(dt_t * A[c, :]) * h_{t-1} + (dt_t * x_t) * B_t    (N states)
//     y_t = sum_n h_t[n] * C_t[n]
//
// in fp32, with y written in x's type and h_final in fp32.  The state is
// read and written in the reference's (B, d_inner, N) layout, so the
// caller needs no transpose (the TPU kernel kept (B, N, d_inner)).  S and
// d_inner are runtime values and the ragged last channel block and time
// span are masked here, so every shape runs this kernel.  expf is the
// full-precision one (no --use_fast_math): exp(dt * A) with very negative
// dt * A underflows to 0 (or a denormal) as the plain version's does.
//
// What bounds it on an H100: at the main path's falcon-mamba prefill
// (4 x 512 tokens, d_inner 8192, N 16, bf16) it reads x and dt (67 MB), B,
// C, A and h0 (2.6 MB) and writes y (34 MB) and h_final (2 MB): about
// 105 MB, 31 us at 3.35 TB/s.  It also does 268 M exp, which the special
// function units, a quarter of the fp32 rate or less, may make the real
// limit.  The recurrence is sequential in time, so the parallelism is
// B * d_inner = 32 K threads, about 8 warps an SM: latency is hidden by the
// N independent states of each thread, not by occupancy.  Its design: one
// thread per (batch, channel) with its N states and A row in registers (N
// a template parameter); blocks of 128 neighbouring channels; for each
// span of 32 time steps the block stages B_t and C_t (shared by all its
// channels) and each thread its own x_t and dt_t column in shared memory,
// loads that are coalesced across the warp and all in flight at once, then
// runs the span from shared memory.  Splitting N over lanes, or a chunked
// parallel scan over time, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // channels per block
constexpr int kSpan = 32;       // time steps staged per pass

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
  return __float2bfloat16(v);   // round to nearest even
}

struct Args {
  const void* x;
  int64_t x_sb, x_ss;
  const void* dt;
  int64_t dt_sb, dt_ss;
  const float* A;               // (d_inner, N), contiguous
  const void* bm;
  int64_t b_sb, b_ss;
  const void* cm;
  int64_t c_sb, c_ss;
  const float* h0;              // (B, d_inner, N), contiguous
  void* y;                      // (B, S, d_inner), contiguous
  float* hf;                    // (B, d_inner, N), contiguous
  int S, di;
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) selective_scan_kernel(Args a) {
  __shared__ float xs[kSpan][kThreads];
  __shared__ float dts[kSpan][kThreads];
  __shared__ float bs[kSpan][N];
  __shared__ float cs[kSpan][N];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int c = blockIdx.x * kThreads + tid;
  const bool live = c < a.di;

  const T* xp = static_cast<const T*>(a.x) + b * a.x_sb + c;
  const T* dtp = static_cast<const T*>(a.dt) + b * a.dt_sb + c;
  const T* bp = static_cast<const T*>(a.bm) + b * a.b_sb;
  const T* cp = static_cast<const T*>(a.cm) + b * a.c_sb;
  T* yp = static_cast<T*>(a.y) + static_cast<int64_t>(b) * a.S * a.di + c;
  const int64_t state = (static_cast<int64_t>(b) * a.di + c) * N;

  float A[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    A[n] = live ? a.A[static_cast<int64_t>(c) * N + n] : 0.0f;
    h[n] = live ? a.h0[state + n] : 0.0f;
  }

  for (int t0 = 0; t0 < a.S; t0 += kSpan) {
    const int span = min(kSpan, a.S - t0);
    __syncthreads();                           // last span consumed
    for (int i = tid; i < span * N; i += kThreads) {
      const int t = i / N, n = i - (i / N) * N;
      bs[t][n] = to_float(bp[(t0 + t) * a.b_ss + n]);
      cs[t][n] = to_float(cp[(t0 + t) * a.c_ss + n]);
    }
    if (live) {
      for (int t = 0; t < span; ++t) {
        xs[t][tid] = to_float(xp[(t0 + t) * a.x_ss]);
        dts[t][tid] = to_float(dtp[(t0 + t) * a.dt_ss]);
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < span; ++t) {
      const float d = dts[t][tid];
      const float dx = d * xs[t][tid];
      float y = 0.0f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(d * A[n]) * h[n] + dx * bs[t][n];
        y = fmaf(h[n], cs[t][n], y);
      }
      yp[static_cast<int64_t>(t0 + t) * a.di] = from_float<T>(y);
    }
  }

  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) a.hf[state + n] = h[n];
  }
}

template <typename T>
int launch_typed(const Args& a, int batch, int n_state, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>((a.di + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(batch));
  switch (n_state) {
    case 8: selective_scan_kernel<T, 8><<<grid, kThreads, 0, stream>>>(a); break;
    case 16:
      selective_scan_kernel<T, 16><<<grid, kThreads, 0, stream>>>(a);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain-C entry point for ctypes.  Pointers are device pointers, strides
// are in elements (the channel and state dims contiguous), `stream` is a
// cudaStream_t passed as an integer.  Returns cudaGetLastError() after
// the launch (0 on success); the caller raises on anything else.
extern "C" int selective_scan_launch(
    const void* x, int64_t x_sb, int64_t x_ss, const void* dt, int64_t dt_sb,
    int64_t dt_ss, const float* A, const void* bm, int64_t b_sb, int64_t b_ss,
    const void* cm, int64_t c_sb, int64_t c_ss, const float* h0, void* y,
    float* hf, int batch, int seq, int d_inner, int n_state, int is_bf16,
    void* stream) {
  Args a;
  a.x = x; a.x_sb = x_sb; a.x_ss = x_ss;
  a.dt = dt; a.dt_sb = dt_sb; a.dt_ss = dt_ss;
  a.A = A;
  a.bm = bm; a.b_sb = b_sb; a.b_ss = b_ss;
  a.cm = cm; a.c_sb = c_sb; a.c_ss = c_ss;
  a.h0 = h0;
  a.y = y;
  a.hf = hf;
  a.S = seq;
  a.di = d_inner;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_typed<__nv_bfloat16>(a, batch, n_state, s)
                 : launch_typed<float>(a, batch, n_state, s);
}
