// Next-event race of the vectorized CTMC engine, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/des_step.py::_event_race_kernel (entered through
// src/repro/kernels/ops.py::event_race).  For each replica row it races
// k_exp exponential clock families (propensities `rates`) against k_det
// deterministic timers (`residuals`):
//
//     total  = sum_j rates[j]                       (sequential)
//     t_exp  = -log(u_time) / max(total, 1e-30)     (+inf if total == 0)
//     pick   = #{j : u_pick >= cumsum_j / max(total, 1e-30)}, clipped to
//              k_exp - 1                           (inverse-CDF pick)
//     t_det  = min_j residuals[j], first index on ties (strict <), an
//              all-+inf row gives lane 0
//     dt     = min(t_exp, t_det)
//     event  = pick if t_exp <= t_det else k_exp + argmin
//
// The arithmetic mirrors repro_torch/kernels/ref.py::event_race_ref step
// for step: a sequential sum and running cumsum, the cdf as a true
// division (not a multiply by a reciprocal), full-precision logf.  Build
// without --use_fast_math so the division and logf stay IEEE/accurate.
// u_time is not clamped (the TPU kernel clamps at 1e-38, the references
// do not); the engine draws uniforms in [1e-12, 1), where both agree.
//
// What bounds it on an H100: per row it reads 16*4 + 3*4 + 2*4 = 84 B and
// writes 8 B at the main path's K_exp = 16, K_det = 3.  At the main
// path's 4,096 rows that is about 377 KB, about 0.11 us at 3.35 TB/s,
// and a few hundred flops per row.  So in practice the kernel is bound
// by launch latency.  The design follows from that: one thread per
// replica row, a 1-D grid of 256-thread blocks, lanes looped over in
// registers, no shared memory.  The TPU's (8, 128) lane and row padding
// is not carried over: the kernel takes the real k_exp, k_det, row count
// and row strides and masks the ragged edge itself.  Fusing it with the
// rest of the step is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void event_race_kernel(const float* __restrict__ rates,
                                  int64_t rates_stride,
                                  const float* __restrict__ residuals,
                                  int64_t resid_stride,
                                  const float* __restrict__ u_time,
                                  int64_t u_time_stride,
                                  const float* __restrict__ u_pick,
                                  int64_t u_pick_stride,
                                  float* __restrict__ dt,
                                  int32_t* __restrict__ event,
                                  int64_t n_rows, int k_exp, int k_det) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (r >= n_rows) return;
  const float* rr = rates + r * rates_stride;
  const float* dr = residuals + r * resid_stride;

  float total = 0.0f;
  for (int j = 0; j < k_exp; ++j) total += rr[j];
  const float safe = fmaxf(total, 1e-30f);
  const float t_exp = total > 0.0f ? -logf(u_time[r * u_time_stride]) / safe
                                   : INFINITY;

  const float up = u_pick[r * u_pick_stride];
  float cum = 0.0f;
  int pick = 0;
  for (int j = 0; j < k_exp; ++j) {
    cum += rr[j];
    pick += (up >= cum / safe) ? 1 : 0;
  }
  pick = min(pick, k_exp - 1);

  float t_det = dr[0];
  int arg = 0;
  for (int j = 1; j < k_det; ++j) {
    const float v = dr[j];
    if (v < t_det) {
      t_det = v;
      arg = j;
    }
  }

  dt[r] = fminf(t_exp, t_det);
  event[r] = t_exp <= t_det ? pick : k_exp + arg;
}

}  // namespace

// Plain-C entry point for ctypes.  Pointers are device pointers; `stream`
// is a cudaStream_t passed as an integer.  Returns cudaGetLastError()
// after the launch (0 on success); the caller raises on anything else.
extern "C" int event_race_launch(const float* rates, int64_t rates_stride,
                                 const float* residuals, int64_t resid_stride,
                                 const float* u_time, int64_t u_time_stride,
                                 const float* u_pick, int64_t u_pick_stride,
                                 float* dt, int32_t* event, int64_t n_rows,
                                 int k_exp, int k_det, void* stream) {
  const int64_t blocks = (n_rows + kThreads - 1) / kThreads;
  event_race_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      rates, rates_stride, residuals, resid_stride, u_time, u_time_stride,
      u_pick, u_pick_stride, dt, event, n_rows, k_exp, k_det);
  return static_cast<int>(cudaGetLastError());
}
