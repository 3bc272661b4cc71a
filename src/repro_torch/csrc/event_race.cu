// Next-event race of the vectorized CTMC engine, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/des_step.py::_event_race_kernel (entered through
// src/repro/kernels/ops.py::event_race).  For each replica row it races
// k_exp exponential clock families (propensities `rates`) against k_det
// deterministic timers (`residuals`), one row a thread, with the race of
// event_race.cuh (which says what it computes and how it mirrors
// repro_torch/kernels/ref.py::event_race_ref).
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
// and row strides and masks the ragged edge itself.  The CTMC main path
// runs the same race fused into its step (ctmc_chunk.cu); this kernel
// serves callers that race lanes of their own.

#include "event_race.cuh"

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
  event_race_row(rates + r * rates_stride, k_exp, nullptr, 0,
                 residuals + r * resid_stride, k_det, u_time[r * u_time_stride],
                 u_pick[r * u_pick_stride], dt + r, event + r);
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
