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
// d_inner are runtime values; the ragged last channel block and time span
// are masked here, so every shape runs this kernel.
//
// What bounds it on an H100: at the main path's falcon-mamba prefill
// (4 x 512 tokens, d_inner 8192, N 16, bf16, B and C column slices of one
// projection) it moves about 105 MB (31 us at 3.35 TB/s) but takes 268 M
// exponentials, 64 us at the special-function units' 16 results a clock
// an SM: that is its bound.  What holds it back in practice is issue
// latency: the prefill shape has 32 K (batch, channel) chains, each
// sequential in time, so the SMs hold few warps, and each warp-step is a
// short dependent chain (exponentials, the state FMA, y's FMAs, a
// shuffle, a store).  scripts/torch_scan_variants.py shows it: without
// the exponentials the kernel takes as long, and the consumers alone
// take 90% of its time.  The design:
//
// * N split over G = kLanes = 2 lanes: the two lanes of a channel are
//   neighbours in a warp, each holds N/2 states and their A entries in
//   registers, and the partial y's of a step are summed by one
//   __shfl_xor_sync, p0 + p1 in both lanes, so results are deterministic.
//   With 8 states a lane, an element costs FMUL (dt * A2), MUFU.EX2, FMUL
//   (dx * B), FFMA (h) and FFMA (y), and a step's loads, shuffle and store
//   about 18 more a lane: ~58 issue slots a warp-step.  At the prefill
//   shape that is 65,536 consumer threads, 16 warps an SM, each with 8
//   independent states to overlap.  G = 4 (4 states, twice the warps)
//   measured slower: its per-step loads, shuffles and stores are spread
//   over half the work.
// * exp(dt * A) = 2^(dt * A2) with A2 = A * log2(e) computed once a lane,
//   by ex2.approx.ftz.f32: one FMUL and one MUFU.EX2 an element where
//   expf takes about six FMA-pipe instructions around its MUFU.  Its
//   error against expf: ex2.approx's 2^-22 relative, plus A2's rounding
//   (2^-24 relative, and log2(e)'s own 2^-25), which moves the argument by
//   |dt * A| * 2^-23 at most and so the result by at most 2^-23 / e
//   absolute; and where dt * A < -126 ln 2, where expf returns a denormal,
//   ex2 returns 0: less than 1.2e-38 apart.  Both stay far inside the
//   tests' 1e-4 (fp32) and 3e-2 (bf16).
// * One producer warp a block moves all the data, so that no consumer
//   ever waits on device memory: while the consumers run span s (32 time
//   steps), it issues span s + 1's x, dt, B and C into a two-stage ring
//   in shared memory by cp.async (in the inputs' own type), writes span
//   s - 1's y rows out of a two-span y buffer, waits for its copies and,
//   in bf16, converts B and C to fp32, so that a consumer lane reads its
//   N/2 values of B_t and C_t as float4 vectors and converts nothing
//   (reading them as bf16x8 and widening them in every lane measured
//   slower).  One __syncthreads a span hands everything over.  Copies and stores are 16
//   bytes where the wrapper finds a tensor's rows 16-byte aligned (its
//   launch plan), and 8, 4 or one element wide where they are not (a
//   d_inner that is not a multiple of 8 in bf16, a B or C slice at an odd
//   offset), inside this same kernel; a bf16 element moves by a plain
//   load, as cp.async has no 2-byte form.  h0, A and h_final move as
//   float4 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 64;   // channels of d_inner a block takes
constexpr int kSpan = 32;       // time steps a ring stage holds
constexpr float kLog2e = 1.4426950408889634f;

// Lanes that split one channel's N states (the wrapper's LANES).
constexpr int kLanes = 2;

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

__device__ __forceinline__ float fast_exp2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// K consecutive floats at p, as float4 (or float2) loads and stores.
template <int K>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = q.x; v[4 * i + 1] = q.y; v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  } else {
    static_assert(K == 2, "N / G is 2 or a multiple of 4");
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}
template <int K>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K / 4; ++i) {
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    }
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

template <int W> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = uint32_t; };
template <> struct Word<2> { using type = uint16_t; };

// cp.async of W bytes; with ok false it reads nothing and writes W zeros.
template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = ok ? W : 0;
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(d), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 ::"r"(d), "l"(src), "n"(W), "r"(n) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// The copies below are made by the block's producer warp: lane l of 32
// takes items l, l + 32, ...

// Stage kSpan rows of LEN elements, row r from src + r * stride, into dst
// (pitch LEN), W bytes a copy; rows >= rows_ok and elements >= len_ok are
// zero-filled.  The plan's W divides len_ok's bytes, so a copy lies wholly
// inside or wholly outside.
template <typename T, int LEN, int W>
__device__ __forceinline__ void stage_rows_w(T* dst, const T* src,
                                             int64_t stride, int rows_ok,
                                             int len_ok, int lane) {
  constexpr int E = W / static_cast<int>(sizeof(T));
  constexpr int kPerRow = LEN / E;
  for (int i = lane; i < kSpan * kPerRow; i += 32) {
    const int r = i / kPerRow, e = (i % kPerRow) * E;
    const bool ok = r < rows_ok && e < len_ok;
    T* d = dst + r * LEN + e;
    const T* s = ok ? src + r * stride + e : src;
    if constexpr (W == 2) {
      using U = Word<2>::type;
      *reinterpret_cast<U*>(d) = ok ? *reinterpret_cast<const U*>(s) : U(0);
    } else {
      cp_async<W>(d, s, ok);
    }
  }
}
template <typename T, int LEN>
__device__ __forceinline__ void stage_rows(int width, T* dst, const T* src,
                                           int64_t stride, int rows_ok,
                                           int len_ok, int lane) {
  switch (width) {
    case 16: stage_rows_w<T, LEN, 16>(dst, src, stride, rows_ok, len_ok, lane);
      break;
    case 8: stage_rows_w<T, LEN, 8>(dst, src, stride, rows_ok, len_ok, lane);
      break;
    case 4: stage_rows_w<T, LEN, 4>(dst, src, stride, rows_ok, len_ok, lane);
      break;
    default:
      if constexpr (sizeof(T) == 2) {
        stage_rows_w<T, LEN, 2>(dst, src, stride, rows_ok, len_ok, lane);
      }
  }
}

// Write rows [0, rows_ok) x [0, len_ok) of src (pitch kChannels) to row r
// of dst at dst + r * stride, W bytes a store.
template <typename T, int W>
__device__ __forceinline__ void store_rows_w(T* dst, const T* src,
                                             int64_t stride, int rows_ok,
                                             int len_ok, int lane) {
  using U = typename Word<W>::type;
  constexpr int E = W / static_cast<int>(sizeof(T));
  constexpr int kPerRow = kChannels / E;
  for (int i = lane; i < rows_ok * kPerRow; i += 32) {
    const int r = i / kPerRow, e = (i % kPerRow) * E;
    if (e < len_ok) {
      *reinterpret_cast<U*>(dst + r * stride + e) =
          *reinterpret_cast<const U*>(src + r * kChannels + e);
    }
  }
}
template <typename T>
__device__ __forceinline__ void store_rows(int width, T* dst, const T* src,
                                           int64_t stride, int rows_ok,
                                           int len_ok, int lane) {
  switch (width) {
    case 16: store_rows_w<T, 16>(dst, src, stride, rows_ok, len_ok, lane);
      break;
    case 8: store_rows_w<T, 8>(dst, src, stride, rows_ok, len_ok, lane);
      break;
    case 4: store_rows_w<T, 4>(dst, src, stride, rows_ok, len_ok, lane);
      break;
    default:
      if constexpr (sizeof(T) == 2) {
        store_rows_w<T, 2>(dst, src, stride, rows_ok, len_ok, lane);
      }
  }
}

// One span of the block's inputs in their own type.
template <typename T, int N>
struct alignas(16) Stage {
  T x[kSpan][kChannels];
  T dt[kSpan][kChannels];
  T b[kSpan][N];
  T c[kSpan][N];
};
// B then C of a span in fp32, two spans: bf16 inputs only (fp32 ones are
// read from the ring as they are).
template <typename T, int N>
struct Converted {
  alignas(16) float bc[2][kSpan][2 * N];
};
template <int N>
struct Converted<float, N> {};
template <typename T, int N>
struct Smem : Converted<T, N> {
  Stage<T, N> ring[2];
  alignas(16) T y[2][kSpan][kChannels];
};

struct Args {
  const void* x;
  int64_t x_sb, x_ss;
  const void* dt;
  int64_t dt_sb, dt_ss;
  const float* A;               // (d_inner, N), contiguous, 16-byte aligned
  const void* bm;
  int64_t b_sb, b_ss;
  const void* cm;
  int64_t c_sb, c_ss;
  const float* h0;              // (B, d_inner, N), as A
  void* y;                      // (B, S, d_inner), contiguous
  float* hf;                    // (B, d_inner, N), as A
  int S, di;
  int wx, wdt, wb, wc, wy;      // bytes a copy (the wrapper's plan)
};

// Threads a block: kChannels * G consumers and one producer warp.
template <int G>
constexpr int threads_for() { return kChannels * G + 32; }

template <typename T, int N, int G>
__global__ void __launch_bounds__(threads_for<G>(), 4)
selective_scan_kernel(Args a) {
  constexpr int NC = kChannels * G;   // consumer threads
  constexpr int K = N / G;            // states a lane
  constexpr bool kConvert = sizeof(T) == 2;
  static_assert(N % G == 0 && 32 % G == 0, "G lanes split N in a warp");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T, N>& sm = *reinterpret_cast<Smem<T, N>*>(smem_raw);

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChannels;
  const int len_ok = a.di - c0;       // the block's channels in d_inner
  const int spans = (a.S + kSpan - 1) / kSpan;

  if (tid >= NC) {
    // ---- the producer warp: span s + 1 in, span s - 1 out -------------
    const int lane = tid - NC;
    const T* xg = static_cast<const T*>(a.x) + b * a.x_sb + c0;
    const T* dtg = static_cast<const T*>(a.dt) + b * a.dt_sb + c0;
    const T* bg = static_cast<const T*>(a.bm) + b * a.b_sb;
    const T* cg = static_cast<const T*>(a.cm) + b * a.c_sb;
    T* yg = static_cast<T*>(a.y) + static_cast<int64_t>(b) * a.S * a.di + c0;
    auto issue = [&](int s) {
      Stage<T, N>& st = sm.ring[s & 1];
      const int t0 = s * kSpan;
      const int rows_ok = min(kSpan, a.S - t0);
      stage_rows<T, kChannels>(a.wx, &st.x[0][0], xg + t0 * a.x_ss, a.x_ss,
                               rows_ok, len_ok, lane);
      stage_rows<T, kChannels>(a.wdt, &st.dt[0][0], dtg + t0 * a.dt_ss,
                               a.dt_ss, rows_ok, len_ok, lane);
      stage_rows<T, N>(a.wb, &st.b[0][0], bg + t0 * a.b_ss, a.b_ss, rows_ok,
                       N, lane);
      stage_rows<T, N>(a.wc, &st.c[0][0], cg + t0 * a.c_ss, a.c_ss, rows_ok,
                       N, lane);
      cp_async_commit();
    };
    auto land = [&](int s) {          // wait for span s; B, C to fp32
      cp_async_wait<0>();
      __syncwarp();
      if constexpr (kConvert) {
        const Stage<T, N>& st = sm.ring[s & 1];
        for (int i = lane; i < kSpan * N; i += 32) {
          const int t = i / N, n = i % N;
          sm.bc[s & 1][t][n] = to_float(st.b[t][n]);
          sm.bc[s & 1][t][N + n] = to_float(st.c[t][n]);
        }
      }
    };
    auto drain = [&](int s) {         // span s's y rows out
      store_rows<T>(a.wy, yg + static_cast<int64_t>(s) * kSpan * a.di,
                    &sm.y[s & 1][0][0], a.di, min(kSpan, a.S - s * kSpan),
                    len_ok, lane);
    };
    if (spans > 0) {
      issue(0);
      land(0);
    }
    __syncthreads();
    for (int s = 0; s < spans; ++s) {
      if (s + 1 < spans) issue(s + 1);
      if (s > 0) drain(s - 1);
      if (s + 1 < spans) land(s + 1);
      __syncthreads();                // span s + 1 in; span s's y written
    }
    if (spans > 0) drain(spans - 1);
    return;
  }

  // ---- the consumers: G lanes a channel ---------------------------------
  const int cl = tid / G;             // channel within the block
  const int g = tid % G;              // lane within the channel
  const int c = c0 + cl;
  const bool live = c < a.di;
  const int64_t state = (static_cast<int64_t>(b) * a.di + c) * N + g * K;

  float h[K], A2[K];
#pragma unroll
  for (int j = 0; j < K; ++j) h[j] = A2[j] = 0.0f;
  if (live) {
    load_vec<K>(a.h0 + state, h);
    load_vec<K>(a.A + static_cast<int64_t>(c) * N + g * K, A2);
#pragma unroll
    for (int j = 0; j < K; ++j) A2[j] *= kLog2e;
  }

  __syncthreads();                    // span 0 in
  for (int s = 0; s < spans; ++s) {
    const Stage<T, N>& st = sm.ring[s & 1];
    const T* xs = &st.x[0][cl];
    const T* dts = &st.dt[0][cl];
    const float* bs;                  // B_t at bs + t * pitch, C_t at + N
    int pitch;
    if constexpr (kConvert) {
      bs = &sm.bc[s & 1][0][g * K];
      pitch = 2 * N;
    } else {
      bs = &st.b[0][g * K];
      pitch = N;
    }
    const int cs = kConvert ? N : kSpan * N;   // C_t - B_t
    T* ys = &sm.y[s & 1][0][cl];
    const int span = min(kSpan, a.S - s * kSpan);
    // step t + 1's operands are loaded before step t's y is stored
    float d_n = to_float(dts[0]), x_n = to_float(xs[0]), b_n[K], c_n[K];
    load_vec<K>(bs, b_n);
    load_vec<K>(bs + cs, c_n);
#pragma unroll 2
    for (int t = 0; t < span; ++t) {
      const float d = d_n, dx = d * x_n;
      float bv[K], cv[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        bv[j] = b_n[j];
        cv[j] = c_n[j];
      }
      const int tn = min(t + 1, span - 1);
      d_n = to_float(dts[tn * kChannels]);
      x_n = to_float(xs[tn * kChannels]);
      load_vec<K>(bs + tn * pitch, b_n);
      load_vec<K>(bs + tn * pitch + cs, c_n);
      float y = 0.0f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float decay = fast_exp2(d * A2[j]);
        h[j] = fmaf(decay, h[j], dx * bv[j]);
        y = fmaf(h[j], cv[j], y);
      }
#pragma unroll
      for (int m = 1; m < G; m <<= 1) {
        y += __shfl_xor_sync(0xffffffffu, y, m);
      }
      if (g == 0) ys[t * kChannels] = from_float<T>(y);
    }
    __syncthreads();                  // span s + 1 in; span s's y written
  }

  if (live) store_vec<K>(a.hf + state, h);
}

template <typename T, int N>
int launch_typed(const Args& a, int batch, cudaStream_t stream) {
  constexpr int G = kLanes;
  constexpr int kSmem = static_cast<int>(sizeof(Smem<T, N>));
  // above 48 KB (float32) only after this, on the current device
  const cudaError_t allowed = cudaFuncSetAttribute(
      selective_scan_kernel<T, N, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const dim3 grid(static_cast<unsigned int>((a.di + kChannels - 1) /
                                            kChannels),
                  static_cast<unsigned int>(batch));
  selective_scan_kernel<T, N, G><<<grid, threads_for<G>(), kSmem, stream>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(const Args& a, int batch, int n_state, cudaStream_t stream) {
  switch (n_state) {
    case 8: return launch_typed<T, 8>(a, batch, stream);
    case 16: return launch_typed<T, 16>(a, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool width_ok(int w, int elem) {
  return w >= elem && (w == 2 || w == 4 || w == 8 || w == 16);
}

}  // namespace

// Plain-C entry point for ctypes.  Pointers are device pointers, strides
// are in elements (the channel and state dims contiguous), `stream` is a
// cudaStream_t passed as an integer.  `lanes` and the five copy widths
// (bytes a copy for x, dt, B, C and y) are the wrapper's launch plan:
// `lanes` must be the kernel's kLanes, and each width one every row
// of its tensor is aligned to.  Returns cudaGetLastError() after the
// launch (0 on success); the caller raises on anything else.
extern "C" int selective_scan_launch(
    const void* x, int64_t x_sb, int64_t x_ss, const void* dt, int64_t dt_sb,
    int64_t dt_ss, const float* A, const void* bm, int64_t b_sb, int64_t b_ss,
    const void* cm, int64_t c_sb, int64_t c_ss, const float* h0, void* y,
    float* hf, int batch, int seq, int d_inner, int n_state, int lanes,
    int wx, int wdt, int wb, int wc, int wy, int is_bf16, void* stream) {
  const int elem = is_bf16 ? 2 : 4;
  if ((n_state != 8 && n_state != 16) || lanes != kLanes ||
      !width_ok(wx, elem) || !width_ok(wdt, elem) || !width_ok(wb, elem) ||
      !width_ok(wc, elem) || !width_ok(wy, elem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  a.wx = wx; a.wdt = wdt; a.wb = wb; a.wc = wc; a.wy = wy;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_n<__nv_bfloat16>(a, batch, n_state, s)
                 : launch_n<float>(a, batch, n_state, s);
}
