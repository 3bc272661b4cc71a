// A chunk of steps of the vectorized CTMC engine, fused into one kernel,
// hand-written for Hopper (sm_90a).
//
// Replaces, on the single-job path with exponential repairs, the Pallas TPU
// kernel src/repro/kernels/des_step.py::_event_race_kernel together with
// the lax.scan of src/repro/core/vectorized.py::_chunk_loop that runs one
// _step_u per step around it.  One launch runs n_steps steps of the port's
// plain step (repro_torch/core/vectorized.py::_step_u) for every replica
// row: the rates and residuals, the race of event_race.cuh, progress and
// rollback, the timer, phase and checkpoint writes, the run-duration ring
// buffer, the counters and diagnosis, the categorical picks over the four
// pools, the replacement waterfall, the repair completions and the
// returning server, and the streaming histograms.
//
// Failure families.  The kernel is a template on the failure family, one
// instance each, chosen by the launch's `kind`; the exponential instance
// is the plain rate race of 16 rates against 3 residuals, and every other
// family's code is compiled out of it.  The other four race 16 rates
// against 4 residuals, the failure family's residual third, and read a
// 9-float uniform row whose ninth lane is u_haz (core/hazards.py):
//   Weibull   -- the failure rates are 0; the residual is the exact
//                inversion (age^k + E/C)^(1/k) - age, E = -log u_haz, C
//                the sum of the 8 hazard shares; when it wins, the failing
//                channel is picked from the shares with u_pick.
//   bathtub   -- the rates are scaled by g_bar = max(g(age), g(age + W));
//                the residual is the window W; a candidate failure is
//                kept when u_haz * g_bar < g(age + dt).
//   lognormal -- each clock (random, systematic) has its own majorant, the
//                hazard at its mode clipped into [age, age + W], and its
//                own accept ratio; log_ndtr is PyTorch's (log_ndtr.cuh).
//   empirical -- the majorant is the current segment rate of each clock,
//                the window runs to the next edge of either clock, and
//                the accept is u_haz * h_bar <= h(age + dt).  Its 4m - 2
//                columns are read from the parameter row, m = n_seg.
//
// Exactness.  Each operation is the plain step's, in its order, in
// float32: the same products and sums (fail_sys = ((run*bad)*r_sys)*
// computing; banked = progress - lost, then work_left - banked), the same
// correctly rounded quotients, logf, and selects in place of torch.where.
// The library is built with -fmad=false, so nvcc contracts no a*b + c into
// an FMA that PyTorch's separate elementwise kernels never form.  Pool
// counts are integer-valued floats, so their sums and cumsums are exact in
// any order.
// Row b reads step k's uniforms at row b % R of the chunk's
// (n_steps, R_draw, 8 or 9) draw, which is what slicing the draw to R and
// tiling it over the P points gives the plain loop.  The hazard math calls
// expf, logf and powf where PyTorch's CUDA kernels call them, in the
// order of core/hazards.py, with every divisor a tensor there (PyTorch's
// CUDA division by a host scalar would multiply by its reciprocal).  So
// on the same state and draw the kernel and the plain loop agree bit for
// bit, up to the libdevice functions' own code under -fmad=false, which
// the card's runs measure (PERF.md).
//
// What bounds it on an H100.  The bytes that must move are the uniforms
// (n_steps x R x 32 B) and each row's state and parameters once in and
// once out (about 270 B a row without its histogram and ring buffer, whose
// few touched bins and slots count as the data needs them): for the
// Table-I sweep's 4,096 rows and 64 steps about 4 MB, 1.2 us at
// 3.35 TB/s; its ~280 float32 operations a live row-step are about 1.1 us
// at 67 TFLOP/s.  So the bound is 1-4 us a launch.  What really sets the
// time is that each row's steps form one dependent chain: a step's race
// needs the previous step's state, and one step is some thousand dependent
// instructions, so a launch takes n_steps times one step's latency.  Of
// these the correctly rounded divisions cost most: on the H100 each took
// about 200 cycles of the chain (timed against __fdividef variants).
//
// What the design does about that.  One thread a row, with the row's whole
// state and parameter row in registers for the launch: the race's inputs
// and outputs and every intermediate never touch memory.  Parallelism
// across SMs is the lever, not occupancy, so blocks are one warp: the
// sweep's 4,096 rows make 128 blocks over the 132 SMs, not 16 blocks of
// 256 threads on 16 SMs.  The next step's two 16-byte uniform loads are
// issued before this step's arithmetic.  Divisions are taken only where
// their quotient is needed, each giving the plain step's quotient: the
// repair rates are kept divided and only the class a step changes is
// divided again; the inverse-CDF tests `u >= cum / total` of the race and
// of the pool picks are decided from the product u * total wherever that
// provably agrees (ge_quot in event_race.cuh); the pools are picked only
// where the pick is used.  The
// histogram bin edges are staged in shared memory once a launch and a
// value's bin comes from a log2 guess that two reads check; a masked
// channel adds one to the row's own bin, which only the row's thread
// touches, so the counts are deterministic.  A row that reaches phase DONE
// leaves its loop: the plain step leaves such a row exactly as it is.  The
// final state is written back in place (the wrapper passes clones unless
// the caller owns them).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "event_race.cuh"
#include "log_ndtr.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kExp = 16;
constexpr int32_t kCompute = 0, kOverhead = 1, kStall = 2, kDone = 3;

// Failure families, in the order of core/hazards.py's HAZARD_KINDS.
enum Kind { kExponential, kWeibull, kBathtub, kLognormal, kEmpirical };
// Empirical segments a clock the kernel takes (kernels/ctmc_chunk.py's
// MAX_SEGMENTS).
constexpr int kMaxSegments = 64;
// PyTorch casts a Python float scalar to the tensor's float32; these
// literals round to the same float32 values (1e-9 and 1e-30 both).
constexpr float kMinDiv = 1e-9f;
constexpr float kMinTotal = 1e-30f;

// Histogram channel codes: the order of repro_torch.core.histograms.
// HIST_CHANNELS (code 3 is goodput).
constexpr int kRunDuration = 0, kRecovery = 1, kWaiting = 2;

// Lane slots of CtmcChunkArgs, in the order of kernels/ctmc_chunk.py's
// COMPARTMENTS, LANES and METRICS.
enum Comp { kRun, kSb, kFw, kFs, kAuto, kMan, kNComp };
enum Lane {
  kT, kWorkLeft, kTimer, kStallStart, kAge, kCurRun, kCkptWork, kInCkpt,
  kNLane
};
enum Metric {
  kTotalTime, kNFailures, kNRandomFailures, kNSystematicFailures,
  kNPreemptions, kNAutoRepairs, kNManualRepairs, kNFailedRepairs,
  kNHostSelections, kNStandbySwaps, kNUndiagnosed, kNMisdiagnosed,
  kStallTime, kRecoveryOverhead, kLostWork, kUsefulWork,
  kCheckpointOverhead, kNMetric
};

}  // namespace

// Pointers and sizes of one launch; kernels/ctmc_chunk.py builds the
// same struct with ctypes.  Every lane is a contiguous CUDA tensor.
struct CtmcChunkArgs {
  float* comp[kNComp];      // (B, 4) pool compartments
  float* lane[kNLane];      // (B,) float32 lanes
  float* metric[kNMetric];  // (B,) float32 metrics the step writes
  int32_t* phase;           // (B,)
  int32_t* n_runs;          // (B,)
  float* run_durations;     // (B, max_runs); null when max_runs == 0
  float* hist;              // (B, n_sel, n_edges + 1); null without
  const float* hist_edges;  // (n_edges,)
  const float* pv;          // parameter rows, columns 0..15 read
  const float* us;          // (n_steps, R_draw, 8) uniforms
  int64_t pv_stride;        // 0: one row shared by the batch
  int64_t n_rows;           // B = P * R
  int64_t R;                // replicas a point: row b reads uniforms b % R
  int64_t R_draw;           // the draw's row count, >= R
  int32_t n_steps;
  int32_t max_runs;
  int32_t n_sel;            // histogram channels carried, 0..4
  int32_t n_edges;
  int32_t chan[4];          // their codes, in HIST_CHANNELS order
  int32_t kind;             // failure family (Kind)
  int32_t n_seg;            // empirical segment count m, else 0
};

namespace {

__device__ __forceinline__ float f(bool b) { return b ? 1.0f : 0.0f; }

// torch.searchsorted(edges, v, right=True): the number of edges <= v, for
// nondecreasing edges.  The log-spaced layout of HistogramSpec gives a
// guess g from log2(v) (lg0 = log2(edges[0]), inv_step = bins per unit of
// log2); g is the answer exactly when edges[g-1] <= v < edges[g], which two
// reads check, and a binary search finds it otherwise.
__device__ __forceinline__ int bin_index(const float* edges, int n, float v,
                                         float lg0, float inv_step) {
  float gf = floorf((__log2f(v) - lg0) * inv_step) + 1.0f;
  gf = fminf(fmaxf(gf, 0.0f), static_cast<float>(n));  // NaN -> 0
  const int g = static_cast<int>(gf);
  if ((g == 0 || edges[g - 1] <= v) && (g == n || !(edges[g] <= v))) {
    return g;
  }
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (edges[mid] <= v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// _pick_classes for one pool: a categorical draw proportional to counts.
__device__ __forceinline__ int pick_class(const float (&c)[4], float u) {
  const float total = fmaxf(((c[0] + c[1]) + c[2]) + c[3], kMinTotal);
  float cum = 0.0f;
  int pick = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    cum += c[j];
    pick += ge_quot(u, cum, total) ? 1 : 0;
  }
  return min(pick, 3);
}

// c[i] for a runtime i in 0..3, by selects (no local-memory indexing).
__device__ __forceinline__ float lane_of(const float (&c)[4], int i) {
  return i == 0 ? c[0] : (i == 1 ? c[1] : (i == 2 ? c[2] : c[3]));
}

__device__ __forceinline__ float sum4(const float (&c)[4]) {
  return ((c[0] + c[1]) + c[2]) + c[3];
}

__device__ __forceinline__ void load4(float (&dst)[4], const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ void store4(float* dst, const float (&src)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2],
                                                src[3]);
}

// ---- failure-hazard math, as core/hazards.py computes it ------------------

// bathtub_shape: 1 + (IF - 1) exp(-t / tau_i) + max(t - t_w, 0) / tau_w.
__device__ __forceinline__ float bathtub_g(float t, float infant_factor,
                                           float infant_tau, float wear_start,
                                           float wear_tau) {
  const float g = 1.0f + (infant_factor - 1.0f) * expf(-t / infant_tau);
  return g + fmaxf(t - wear_start, 0.0f) / wear_tau;
}

// lognormal_hazard: f(t) / S(t) of a lognormal clock; 0 for scale <= 0.
__device__ __forceinline__ float lognormal_h(float t, float scale,
                                             float sigma, float log_sigma) {
  constexpr float kLogSqrt2Pi = 0.91893853320467274178f;
  const float log_t = logf(fmaxf(t, 1e-30f));
  const float z = (log_t - logf(fmaxf(scale, 1e-30f))) / sigma;
  const float log_h = (((-0.5f * z) * z - kLogSqrt2Pi) - log_ndtr(-z))
                      - log_sigma - log_t;
  return scale > 0.0f ? expf(log_h) : 0.0f;
}

// lognormal_window_majorant: the hazard at the mode clipped into the window.
__device__ __forceinline__ float lognormal_bar(float age, float window,
                                               float scale, float sigma,
                                               float log_sigma,
                                               float mode_rel) {
  const float t_star = fminf(fmaxf(scale * mode_rel, age), age + window);
  return lognormal_h(t_star, scale, sigma, log_sigma);
}

// piecewise_hazard: rates[#{i : t >= edges[i]}] (m - 1 edges, m rates).
__device__ __forceinline__ float piecewise_h(float t, const float* edges,
                                             const float* rates, int m) {
  int idx = 0;
  for (int i = 0; i < m - 1; ++i) idx += t >= __ldg(edges + i) ? 1 : 0;
  return __ldg(rates + idx);
}

// piecewise_next_edge: distance to the nearest edge above t (+inf if none).
__device__ __forceinline__ float piecewise_gap(float t, const float* edges,
                                               int m) {
  float gap = INFINITY;
  for (int i = 0; i < m - 1; ++i) {
    const float e = __ldg(edges + i);
    if (e > t) gap = fminf(gap, e - t);
  }
  return gap;
}

template <int kKind>
__global__ void __launch_bounds__(kThreads)
    ctmc_chunk_kernel(const CtmcChunkArgs a) {
  constexpr bool kExpOnly = kKind == kExponential;
  // residuals raced: completion, timer, [the family's], checkpoint write
  constexpr int kDet = kExpOnly ? 3 : 4;
  extern __shared__ float s_edges[];
  for (int i = threadIdx.x; i < a.n_edges; i += blockDim.x) {
    s_edges[i] = a.hist_edges[i];
  }
  __syncthreads();
  // the bin guess's scale (only a guess: bin_index checks it)
  const float lg0 = a.n_edges > 0 ? __log2f(s_edges[0]) : 0.0f;
  const float lg_span =
      a.n_edges > 1 ? __log2f(s_edges[a.n_edges - 1]) - lg0 : 0.0f;
  const float inv_step = a.n_edges > 1 ? (a.n_edges - 1) / lg_span : 0.0f;

  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (b >= a.n_rows) return;
  int32_t phase = a.phase[b];
  if (phase == kDone || a.n_steps == 0) return;   // inert: nothing changes

  // ---- parameters ------------------------------------------------------
  const float* p = a.pv + b * a.pv_stride;
  const float r_rand = p[0], r_sys = p[1], recovery = p[2], host_sel = p[3];
  const float waiting = p[4], auto_t = p[5], man_t = p[6];
  const float auto_fail = p[7], man_fail = p[8], p_auto = p[9];
  const float dp = p[10], du = p[11], ckpt = p[12], preempt_cost = p[13];
  const float warm_standbys = p[14], ckpt_cost = p[15];
  const float auto_div = fmaxf(auto_t, kMinDiv);
  const float man_div = fmaxf(man_t, kMinDiv);
  // the failure family's columns (hazard_columns); the empirical block is
  // [rand edges (m-1), rand rates (m), sys edges (m-1), sys rates (m)]
  const float hz0 = kExpOnly || kKind == kEmpirical ? 0.0f : p[16];
  const float hz1 = kExpOnly || kKind == kEmpirical ? 0.0f : p[17];
  const float hz2 = kExpOnly || kKind == kEmpirical ? 0.0f : p[18];
  const float hz3 = kExpOnly || kKind == kEmpirical ? 0.0f : p[19];
  const float hz4 = kExpOnly || kKind == kEmpirical ? 0.0f : p[20];
  const int n_seg = a.n_seg;
  const float* e_re = p + 16;
  const float* e_rr = e_re + (n_seg - 1);
  const float* e_se = e_rr + n_seg;
  const float* e_sr = e_se + (n_seg - 1);
  // Weibull: 1 / k as PyTorch's reciprocal gives it; lognormal: log(sigma)
  const float inv_k = kKind == kWeibull ? 1.0f / hz2 : 0.0f;
  const float log_sigma = kKind == kLognormal ? logf(hz2) : 0.0f;

  // ---- the row's state ---------------------------------------------------
  float run[4], sb[4], fw[4], fs[4], aut[4], man[4];
  load4(run, a.comp[kRun] + 4 * b);
  load4(sb, a.comp[kSb] + 4 * b);
  load4(fw, a.comp[kFw] + 4 * b);
  load4(fs, a.comp[kFs] + 4 * b);
  load4(aut, a.comp[kAuto] + 4 * b);
  load4(man, a.comp[kMan] + 4 * b);
  float t = a.lane[kT][b], work_left = a.lane[kWorkLeft][b];
  float timer = a.lane[kTimer][b], stall_start = a.lane[kStallStart][b];
  float age = a.lane[kAge][b], cur_run = a.lane[kCurRun][b];
  float ckpt_work = a.lane[kCkptWork][b], in_ckpt = a.lane[kInCkpt][b];
  int32_t n_runs = a.n_runs[b];
  float m[kNMetric];
#pragma unroll
  for (int i = 0; i < kNMetric; ++i) m[i] = a.metric[i][b];

  // the repair rates aut[j] / auto_div and man[j] / man_div, kept
  // divided: a step changes at most one class of each pool, and only that
  // class is divided again
  float q_aut[4], q_man[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    q_aut[j] = aut[j] / auto_div;
    q_man[j] = man[j] / man_div;
  }

  // the next step's uniforms, loaded before this step's arithmetic: two
  // float4s of an 8-float row, nine floats of a 9-float (36-byte) row
  const float4* ub = reinterpret_cast<const float4*>(a.us) + 2 * (b % a.R);
  const int64_t u_step = 2 * a.R_draw;             // float4s a step
  const float* ub9 = a.us + 9 * (b % a.R);
  const int64_t u_step9 = 9 * a.R_draw;            // floats a step
  float4 n0, n1;
  float n8 = 0.0f;
  if constexpr (kExpOnly) {
    n0 = __ldg(ub);
    n1 = __ldg(ub + 1);
  } else {
    n0 = make_float4(__ldg(ub9), __ldg(ub9 + 1), __ldg(ub9 + 2),
                     __ldg(ub9 + 3));
    n1 = make_float4(__ldg(ub9 + 4), __ldg(ub9 + 5), __ldg(ub9 + 6),
                     __ldg(ub9 + 7));
    n8 = __ldg(ub9 + 8);
  }

  for (int k = 0; k < a.n_steps; ++k) {
    // u_time, u_pick, u_diag, u_wrong | u_cls, u_esc, u_succ, u_pool
    // [| u_haz]
    const float4 u0 = n0, u1 = n1;
    const float u_haz = n8;
    if (k + 1 < a.n_steps) {
      if constexpr (kExpOnly) {
        n0 = __ldg(ub + (k + 1) * u_step);
        n1 = __ldg(ub + (k + 1) * u_step + 1);
      } else {
        const float* un = ub9 + (k + 1) * u_step9;
        n0 = make_float4(__ldg(un), __ldg(un + 1), __ldg(un + 2),
                         __ldg(un + 3));
        n1 = make_float4(__ldg(un + 4), __ldg(un + 5), __ldg(un + 6),
                         __ldg(un + 7));
        n8 = __ldg(un + 8);
      }
    }

    const bool computing = phase == kCompute;
    const bool in_overhead = phase == kOverhead;
    const bool stalled = phase == kStall;
    const bool active = phase != kDone;
    const bool in_ckpt_flag = in_ckpt > 0.0f;

    // ---- rates and residuals -------------------------------------------
    float rates[kExp];
    float resid[kDet];
    // the family's state of this step: the Weibull hazard shares and
    // their sum, the bathtub majorant, the lognormal / empirical
    // majorants of the random and systematic clocks
    float w8[8], w_total = 0.0f, g_bar = 0.0f, hbar_r = 0.0f, hbar_s = 0.0f;
    if constexpr (kKind == kWeibull) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float bad = f(j % 2 == 1);
        w8[j] = (run[j] * hz0) * f(computing);
        w8[4 + j] = ((run[j] * bad) * hz1) * f(computing);
      }
      w_total = w8[0];
#pragma unroll
      for (int j = 1; j < 8; ++j) w_total += w8[j];
      float s = INFINITY;
      if (w_total > 0.0f) {
        const float target = powf(age, hz2)
                             + (-logf(u_haz)) / fmaxf(w_total, kMinTotal);
        s = fmaxf(powf(target, inv_k) - age, 0.0f);
      }
      resid[2] = s;
    } else if constexpr (kKind == kBathtub) {
      g_bar = fmaxf(bathtub_g(age, hz0, hz1, hz2, hz3),
                    bathtub_g(age + hz4, hz0, hz1, hz2, hz3));
      resid[2] = computing ? hz4 : INFINITY;
    } else if constexpr (kKind == kLognormal) {
      hbar_r = lognormal_bar(age, hz4, hz0, hz2, log_sigma, hz3);
      hbar_s = lognormal_bar(age, hz4, hz1, hz2, log_sigma, hz3);
      resid[2] = computing ? (hz4 > 0.0f ? hz4 : INFINITY) : INFINITY;
    } else if constexpr (kKind == kEmpirical) {
      hbar_r = piecewise_h(age, e_re, e_rr, n_seg);
      hbar_s = piecewise_h(age, e_se, e_sr, n_seg);
      resid[2] = computing ? fminf(piecewise_gap(age, e_re, n_seg),
                                   piecewise_gap(age, e_se, n_seg))
                           : INFINITY;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bad = f(j % 2 == 1);
      if constexpr (kExpOnly) {
        rates[j] = ((run[j] * r_rand) * f(computing)) * f(active);
        rates[4 + j] = (((run[j] * bad) * r_sys) * f(computing)) * f(active);
      } else if constexpr (kKind == kWeibull) {
        rates[j] = 0.0f;
        rates[4 + j] = 0.0f;
      } else if constexpr (kKind == kBathtub) {
        rates[j] = (((run[j] * r_rand) * g_bar) * f(computing)) * f(active);
        rates[4 + j] = ((((run[j] * bad) * r_sys) * g_bar) * f(computing))
                       * f(active);
      } else {
        rates[j] = ((run[j] * hbar_r) * f(computing)) * f(active);
        rates[4 + j] = (((run[j] * bad) * hbar_s) * f(computing))
                       * f(active);
      }
      rates[8 + j] = q_aut[j] * f(active);
      rates[12 + j] = q_man[j] * f(active);
    }
    resid[0] = computing ? work_left : INFINITY;
    resid[1] = in_overhead ? timer : INFINITY;
    resid[kDet - 1] = (computing && ckpt > 0.0f)
                          ? fmaxf(ckpt - ckpt_work, 0.0f)
                          : INFINITY;
    float dt;
    int32_t ev;
    event_race_row(rates, kExp, resid, kDet, u0.x, u0.y, &dt, &ev);
    dt = (active && isfinite(dt)) ? dt : 0.0f;

    int32_t cls = ev % 4;
    bool is_fail = active && ev < 8;
    bool is_sys = active && ev >= 4 && ev < 8;
    if constexpr (kKind == kWeibull) {
      // the failure arrives on the hazard residual; the failing channel
      // is picked from the hazard shares with u_pick
      const bool haz_fail = active && ev == kExp + 2;
      if (haz_fail) {
        const float total = fmaxf(w_total, kMinTotal);
        float cum = 0.0f;
        int pick8 = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          cum = j == 0 ? w8[0] : cum + w8[j];
          pick8 += u0.y >= cum / total ? 1 : 0;
        }
        pick8 = min(pick8, 7);
        cls = pick8 % 4;
        is_sys = pick8 >= 4;
      } else {
        is_sys = false;
      }
      is_fail = haz_fail;
    } else if constexpr (kKind == kBathtub) {
      if (is_fail) {
        const bool accept =
            u_haz * g_bar < bathtub_g(age + dt, hz0, hz1, hz2, hz3);
        is_fail = accept;
        is_sys = is_sys && accept;
      }
    } else if constexpr (kKind == kLognormal) {
      if (is_fail) {
        const bool cand_sys = ev >= 4;
        const float h_at = lognormal_h(age + dt, cand_sys ? hz1 : hz0, hz2,
                                       log_sigma);
        const bool accept = u_haz * (cand_sys ? hbar_s : hbar_r) < h_at;
        is_fail = accept;
        is_sys = is_sys && accept;
      }
    } else if constexpr (kKind == kEmpirical) {
      if (is_fail) {
        const bool cand_sys = ev >= 4;
        const float h_at = cand_sys ? piecewise_h(age + dt, e_se, e_sr, n_seg)
                                    : piecewise_h(age + dt, e_re, e_rr, n_seg);
        const bool accept = u_haz * (cand_sys ? hbar_s : hbar_r) <= h_at;
        is_fail = accept;
        is_sys = is_sys && accept;
      }
    }
    const bool is_auto = active && ev >= 8 && ev < 12;
    const bool is_man = active && ev >= 12 && ev < 16;
    const bool is_complete = active && ev == kExp;
    const bool is_timer = active && ev == kExp + 1;
    const bool is_ckpt = active && ev == kExp + kDet - 1;

    const float t_new = t + dt;

    // ---- progress accounting -------------------------------------------
    const float progress = computing ? dt : 0.0f;
    const float new_ckpt_work = ckpt_work + progress;
    const float lost = (is_fail && ckpt > 0.0f) ? new_ckpt_work : 0.0f;
    const float banked = progress - lost;
    work_left = work_left - banked;
    m[kUsefulWork] = m[kUsefulWork] + banked;
    m[kLostWork] = m[kLostWork] + lost;
    ckpt_work = (is_fail || is_ckpt || is_complete) ? 0.0f : new_ckpt_work;

    // ---- completion / timer ---------------------------------------------
    const float timer_dec = in_overhead ? timer - dt : timer;
    int32_t phase_n = is_complete ? kDone : phase;
    phase_n = is_timer ? kCompute : phase_n;
    float timer_n = is_timer ? INFINITY : timer_dec;
    m[kTotalTime] = is_complete ? t_new : m[kTotalTime];

    // ---- checkpoint writes ----------------------------------------------
    const bool paid_ckpt = is_ckpt && ckpt_cost > 0.0f;
    phase_n = paid_ckpt ? kOverhead : phase_n;
    timer_n = paid_ckpt ? ckpt_cost : timer_n;
    in_ckpt = is_timer ? 0.0f : (paid_ckpt ? 1.0f : in_ckpt);
    m[kCheckpointOverhead] = m[kCheckpointOverhead]
                             + (in_ckpt_flag ? dt : 0.0f);

    // ---- exact run durations --------------------------------------------
    const bool record = is_fail || is_complete;
    const float run_val = cur_run + progress;
    if (record && a.max_runs > 0) {
      a.run_durations[b * a.max_runs + n_runs % a.max_runs] = run_val;
    }
    n_runs += record ? 1 : 0;
    cur_run = record ? 0.0f : run_val;

    // ---- phase age ------------------------------------------------------
    age = (is_timer && !in_ckpt_flag) ? 0.0f : age + progress;

    // ---- failure handling ----------------------------------------------
    m[kNFailures] = m[kNFailures] + f(is_fail);
    m[kNSystematicFailures] = m[kNSystematicFailures] + f(is_sys);
    m[kNRandomFailures] = m[kNRandomFailures] + f(is_fail && !is_sys);

    const bool diagnosed = is_fail && (u0.z < dp);
    const bool wrong = diagnosed && (u0.w < du);
    m[kNUndiagnosed] = m[kNUndiagnosed] + f(is_fail && !diagnosed);
    m[kNMisdiagnosed] = m[kNMisdiagnosed] + f(wrong);

    const bool use_sb = diagnosed && (sum4(sb) > 0.0f);
    const bool use_fw = diagnosed && !use_sb && (sum4(fw) > 0.0f);
    const bool use_fs = diagnosed && !use_sb && !use_fw && (sum4(fs) > 0.0f);
    const bool goes_stall = diagnosed && !use_sb && !use_fw && !use_fs;

    // the picks only matter where a server is removed (the run pool's on a
    // wrong diagnosis) or taken (the one pool the waterfall uses): the
    // plain step multiplies every other pick by zero, so they are left at
    // 0, and the three waterfall pools share the one pick that is used
    int p_run = 0, p_take = 0;
    if (wrong) p_run = pick_class(run, u1.x);
    if (use_sb || use_fw || use_fs) {
      float pool[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pool[j] = use_sb ? sb[j] : (use_fw ? fw[j] : fs[j]);
      }
      p_take = pick_class(pool, use_sb ? u1.x : u1.w);
    }
    const int p_sb = p_take, p_fw = p_take, p_fs = p_take;

    float run_n[4], sb_n[4], fw_n[4], fs_n[4], aut_n[4], man_n[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float rm = (wrong ? f(p_run == j) : f(cls == j)) * f(diagnosed);
      run_n[j] = run[j] - rm;
      aut_n[j] = aut[j] + rm;
      const float take = (f(p_sb == j) * f(use_sb) + f(p_fw == j) * f(use_fw))
                         + f(p_fs == j) * f(use_fs);
      sb_n[j] = sb[j] - f(p_sb == j) * f(use_sb);
      fw_n[j] = fw[j] - f(p_fw == j) * f(use_fw);
      fs_n[j] = fs[j] - f(p_fs == j) * f(use_fs);
      run_n[j] = run_n[j] + take;
    }
    m[kNStandbySwaps] = m[kNStandbySwaps] + f(use_sb);
    m[kNHostSelections] = m[kNHostSelections] + f(use_fw || use_fs);
    m[kNPreemptions] = m[kNPreemptions] + f(use_fs);

    const float fail_timer = (recovery + ((use_fw || use_fs) ? host_sel
                                                             : 0.0f))
                             + (use_fs ? waiting + preempt_cost : 0.0f);
    const bool resolves = is_fail && !goes_stall;
    timer_n = resolves ? fail_timer : timer_n;
    phase_n = resolves ? kOverhead : phase_n;
    phase_n = goes_stall ? kStall : phase_n;
    const float stall_start_n = goes_stall ? t_new : stall_start;
    const float recovery_oh = m[kRecoveryOverhead]
                              + (resolves ? recovery : 0.0f);

    // ---- repair completions ----------------------------------------------
    m[kNAutoRepairs] = m[kNAutoRepairs] + f(is_auto);
    const bool escalate = is_auto && (u1.y >= p_auto);
    m[kNManualRepairs] = m[kNManualRepairs] + f(is_man);
    const bool finishes = (is_auto && !escalate) || is_man;
    const float fail_prob = is_man ? man_fail : auto_fail;
    const bool healed = finishes && (u1.z >= fail_prob);
    m[kNFailedRepairs] = m[kNFailedRepairs] + f(finishes && !healed);
    const int32_t out_cls = healed ? cls - (cls % 2) : cls;

    // returning server: stalled job > standby refill > origin pool
    const bool to_stalled = finishes && stalled;
    const bool to_sb = finishes && !to_stalled
                       && (sum4(sb_n) < warm_standbys);
    const bool to_pool = finishes && !to_stalled && !to_sb;
    const bool spare_origin = out_cls >= 2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      aut_n[j] = aut_n[j] - f(cls == j) * f(is_auto);
      man_n[j] = man[j] + f(cls == j) * f(escalate);
      man_n[j] = man_n[j] - f(cls == j) * f(is_man);
      const float out = f(out_cls == j);
      run_n[j] = run_n[j] + out * f(to_stalled);
      sb_n[j] = sb_n[j] + out * f(to_sb);
      fw_n[j] = fw_n[j] + out * f(to_pool && !spare_origin);
      fs_n[j] = fs_n[j] + out * f(to_pool && spare_origin);
    }
    phase_n = to_stalled ? kOverhead : phase_n;
    timer_n = to_stalled ? recovery : timer_n;
    m[kStallTime] = m[kStallTime] + (to_stalled ? t_new - stall_start : 0.0f);
    m[kRecoveryOverhead] = recovery_oh + (to_stalled ? recovery : 0.0f);

    // ---- streaming histograms -------------------------------------------
    const bool ended = resolves || to_stalled;
    if (a.n_sel > 0 && (record || ended)) {
      const float stall_wait = t_new - stall_start;
      const float downtime = resolves ? fail_timer : stall_wait + recovery;
      const float acquire_wait = resolves ? fail_timer - recovery
                                          : stall_wait;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= a.n_sel) break;
        const int code = a.chan[c];
        float v;
        bool mask;
        if (code == kRunDuration) {
          v = run_val;
          mask = record;
        } else if (code == kRecovery) {
          v = downtime;
          mask = ended;
        } else if (code == kWaiting) {
          v = acquire_wait;
          mask = ended;
        } else {  // goodput
          v = m[kUsefulWork] / fmaxf(t_new, kMinDiv);
          mask = is_complete;
        }
        if (mask) {
          const int idx = bin_index(s_edges, a.n_edges, v, lg0, inv_step);
          atomicAdd(a.hist + (b * a.n_sel + c) * (a.n_edges + 1) + idx,
                    1.0f);
        }
      }
    }

    // ---- commit ---------------------------------------------------------
    t = t_new;
    timer = timer_n;
    phase = phase_n;
    stall_start = stall_start_n;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      run[j] = run_n[j];
      sb[j] = sb_n[j];
      fw[j] = fw_n[j];
      fs[j] = fs_n[j];
      aut[j] = aut_n[j];
      man[j] = man_n[j];
    }
    if (diagnosed || is_auto) {
      const int ja = is_auto ? cls : (wrong ? p_run : cls);
      const float q = lane_of(aut, ja) / auto_div;
#pragma unroll
      for (int j = 0; j < 4; ++j) q_aut[j] = j == ja ? q : q_aut[j];
    }
    if (escalate || is_man) {
      const float q = lane_of(man, cls) / man_div;
#pragma unroll
      for (int j = 0; j < 4; ++j) q_man[j] = j == cls ? q : q_man[j];
    }
    // a finished row stays as it is for the rest of the chunk
    if (phase == kDone) break;
  }

  store4(a.comp[kRun] + 4 * b, run);
  store4(a.comp[kSb] + 4 * b, sb);
  store4(a.comp[kFw] + 4 * b, fw);
  store4(a.comp[kFs] + 4 * b, fs);
  store4(a.comp[kAuto] + 4 * b, aut);
  store4(a.comp[kMan] + 4 * b, man);
  a.lane[kT][b] = t;
  a.lane[kWorkLeft][b] = work_left;
  a.lane[kTimer][b] = timer;
  a.lane[kStallStart][b] = stall_start;
  a.lane[kAge][b] = age;
  a.lane[kCurRun][b] = cur_run;
  a.lane[kCkptWork][b] = ckpt_work;
  a.lane[kInCkpt][b] = in_ckpt;
  a.phase[b] = phase;
  a.n_runs[b] = n_runs;
#pragma unroll
  for (int i = 0; i < kNMetric; ++i) a.metric[i][b] = m[i];
}

}  // namespace

template <int kKind>
static int launch(const CtmcChunkArgs* args, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(args->n_edges) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ctmc_chunk_kernel<kKind>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (args->n_rows + kThreads - 1) / kThreads;
  ctmc_chunk_kernel<kKind>
      <<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// Plain-C entry point for ctypes.  `args` points to the launch's struct in
// host memory; `stream` is a cudaStream_t passed as an integer.  Returns
// the first CUDA error of the shared-memory attribute or the launch (0 on
// success), or cudaErrorInvalidValue for a family or segment count the
// kernel does not take; the caller raises on anything else.
extern "C" int ctmc_chunk_launch(const CtmcChunkArgs* args, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool seg_ok = args->kind == kEmpirical
                          ? args->n_seg >= 2 && args->n_seg <= kMaxSegments
                          : args->n_seg == 0;
  if (!seg_ok) return static_cast<int>(cudaErrorInvalidValue);
  switch (args->kind) {
    case kExponential: return launch<kExponential>(args, s);
    case kWeibull: return launch<kWeibull>(args, s);
    case kBathtub: return launch<kBathtub>(args, s);
    case kLognormal: return launch<kLognormal>(args, s);
    case kEmpirical: return launch<kEmpirical>(args, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
