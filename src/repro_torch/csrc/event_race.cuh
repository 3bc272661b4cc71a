// The next-event race of the vectorized CTMC engine for one replica row,
// shared by the standalone race kernel (event_race.cu) and the fused CTMC
// chunk kernel (ctmc_chunk.cu), so the port has one race.
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
// The arithmetic mirrors repro_torch/kernels/ref.py::event_race_ref: a
// sequential sum and running cumsum, the cdf as a true division (not a
// multiply by a reciprocal), full-precision logf.  The pick tests the cdf
// only at the boundary its products point to, and decides each test from
// a product where that is provably the division's answer (ge_quot), which
// gives the same count for any rates >= 0 and uniforms > 0 with almost no
// division.  Build without --use_fast_math so the division and logf
// stay IEEE/accurate.
// With constant k_exp and k_det after inlining (the chunk kernel's 16 and
// 3) the loops unroll and the lanes stay in registers.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// u >= c / s, with the correctly rounded quotient, for c >= 0 and s > 0,
// dividing only when it must.  For c == 0 the quotient is +0.  Where
// u and u * s are normal, the product decides: u * s >= c * (1 + 2^-20)
// gives u >= (c / s)(1 + 2^-20)(1 - 2^-24)/(1 + 2^-24) > fl(c / s), and
// (u * s) * (1 + 2^-20) <= c gives u < (c / s)(1 - 2^-21) < fl(c / s) (a
// quotient below FLT_MIN is below u >= 2^-100 either way).  Only inside
// that margin, about 2^-20 of a uniform's range, is the division taken.
__device__ __forceinline__ bool ge_quot(float u, float c, float s) {
  constexpr float kMargin = 1.0f + 0x1p-20f;
  if (c == 0.0f) return u >= 0.0f;
  const float p = u * s;
  if (u >= 0x1p-100f && p >= 0x1p-126f) {
    if (p >= c * kMargin) return true;
    if (p * kMargin <= c) return false;
  }
  return u >= c / s;
}

// The race over k_exp lanes in `rates` (in registers, after inlining with
// a constant k_exp) followed by n_extra lanes read in order from `extra`
// (a fault-domain scenario's shock rates, the same every step, so they stay
// in memory; any count).  Callers without such lanes pass nullptr and a
// literal 0, and the extra loops compile away.  The sum runs over the
// k_exp lanes, then the extra ones, the plain race's order.
__device__ __forceinline__ void event_race_row(const float* rates, int k_exp,
                                               const float* extra,
                                               int n_extra,
                                               const float* residuals,
                                               int k_det, float u_time,
                                               float u_pick, float* dt,
                                               int32_t* event) {
  const int k_all = k_exp + n_extra;
  float total = 0.0f;
#pragma unroll
  for (int j = 0; j < k_exp; ++j) total += rates[j];
  for (int j = 0; j < n_extra; ++j) total += __ldg(extra + j);
  const float safe = fmaxf(total, 1e-30f);
  const float t_exp = total > 0.0f ? -logf(u_time) / safe : INFINITY;

  // The cdf is nondecreasing in j (rates >= 0) and a correctly rounded
  // division by safe > 0 is monotone, so `u_pick >= cdf_j` holds for a
  // prefix of j and pick is that prefix's length.  A guess from the
  // products (u_pick * safe >= cumsum_j, also a prefix) is checked on both
  // sides of its boundary with the exact test of ge_quot; only if either
  // check fails is every lane tested.  Either way pick is the count of the
  // true-division test, as in the plain version.  The extra lanes' guess
  // and exact count stop at the first lane past u_pick.
  const float u_scaled = u_pick * safe;
  float cum = 0.0f, cum_lo = 0.0f, cum_hi = 0.0f;
  int guess = 0;
  bool past = false;
#pragma unroll
  for (int j = 0; j < k_exp; ++j) {
    cum += rates[j];
    const bool below = u_scaled >= cum;
    guess += below ? 1 : 0;
    cum_lo = below ? cum : cum_lo;
    cum_hi = (!below && !past) ? cum : cum_hi;
    past = past || !below;
  }
  for (int j = 0; j < n_extra && !past; ++j) {
    cum += __ldg(extra + j);
    if (u_scaled >= cum) {
      guess += 1;
      cum_lo = cum;
    } else {
      cum_hi = cum;
      past = true;
    }
  }
  int pick = guess;
  const bool lo_ok = guess == 0 || ge_quot(u_pick, cum_lo, safe);
  const bool hi_ok = guess == k_all || !ge_quot(u_pick, cum_hi, safe);
  if (!(lo_ok && hi_ok)) {
    cum = 0.0f;
    pick = 0;
#pragma unroll
    for (int j = 0; j < k_exp; ++j) {
      cum += rates[j];
      pick += ge_quot(u_pick, cum, safe) ? 1 : 0;
    }
    for (int j = 0; j < n_extra && pick == k_exp + j; ++j) {
      cum += __ldg(extra + j);
      pick += ge_quot(u_pick, cum, safe) ? 1 : 0;
    }
  }
  pick = min(pick, k_all - 1);

  float t_det = residuals[0];
  int arg = 0;
#pragma unroll
  for (int j = 1; j < k_det; ++j) {
    const float v = residuals[j];
    if (v < t_det) {
      t_det = v;
      arg = j;
    }
  }

  *dt = fminf(t_exp, t_det);
  *event = t_exp <= t_det ? pick : k_all + arg;
}
