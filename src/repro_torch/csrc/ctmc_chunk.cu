// A chunk of steps of the vectorized CTMC engine, fused into one kernel,
// hand-written for Hopper (sm_90a).
//
// Replaces, on the single-job path, the Pallas TPU kernel
// src/repro/kernels/des_step.py::_event_race_kernel together with the
// lax.scan of src/repro/core/vectorized.py::_chunk_loop that runs one
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
// Repair families.  Exponential repairs race the 8 repair clocks of the
// auto and manual compartments.  A non-exponential repair family (Weibull,
// lognormal, deterministic, empirical: core/hazards.py's REPAIR_KINDS)
// runs a slot instance of each failure family instead: the repair clocks
// carry no rate, the row's repair-slot lane (the remaining repair time,
// class and stage of each server in the shop) is raced first among the
// residuals through its minimum, a winning slot's class and stage decide
// the completion, every slot counts down by dt each step, and a diagnosed
// failure takes the first free slot.  A duration is drawn on the row's last
// uniform, u_dur, by the family's inverse CDF (quantile below, ndtri.cuh),
// only on a step where a server enters the shop or escalates, as the plain
// step uses it; the repair family is a switch uniform over the launch
// inside that rarely taken block, so there are five slot instances, one a
// failure family, not twenty.
//
// Fault-domain scenarios.  A scenario with exponential repairs runs a
// scenario instance of each failure family (kScenBit), a thread a row: the
// race's exponential lanes are the 16 and then one shock lane a domain,
// D of them for any D (45 for 40 racks in pods of 8; up to the fleet), read
// in order from the row's parameter columns by event_race_row, since
// they do not fit a thread's registers; the campaign's next entry is raced
// first among the residuals; a maintenance window gates the repair clocks
// to zero.  A shock or scripted kill (the struck step) sizes its kill and
// refill in bulk_kill, out of line, on the uniforms the failure path leaves
// idle, and the deficit lane holds the job stalled until the whole struck
// block is back.  The scenario-free instances compile to their earlier
// code: every scenario branch is behind `if constexpr`.
//
// Float64 age.  Under Params.age_dtype="float64" the failure-age lane and
// the repair-slot lane's remaining times are float64, the reference's
// carve-out for the cancellation of the Weibull inversion at large ages.
// Every instance is a template on the age type AgeT as well: this source
// builds the float instances by default and, with -DCTMC_AGE_T=double,
// their double twins in a library of their own (kernels/ctmc_chunk.py's
// LIBRARY64), so the float library's code is what it was.  The double
// instances take the plain step's promotions and nothing more: the Weibull
// inversion in double (pow, E and C cast up, the residual rounded to float
// for the race), age + progress in double, the slot lane's minimum in
// double rounded to float for the race, the decrement by dt cast up, and a
// float quantile cast up on entry; the thinning families' hazards read the
// float view of the age, as the reference's age32.  The H100 runs double at
// half its float rate on the CUDA cores, and a row's chain has a handful
// of double operations a step.
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
// A slot instance also moves each row's repair-slot lane in and out, 12
// bytes a slot: at 128 slots a row that is 12.6 MB of the sweep's ~17 MB
// a launch, about 6 us.  A scenario instance also reads 2D + 3L + 3 more
// parameter columns a row and does two more operations a shock lane a
// step (the sum and the cumsum): at 45 domains and 4,096 rows about 2.5 us
// a launch, set by bytes; on an H100 a launch took 0.27 ms (PERF.md), 40%
// of it the 45 shock lanes and the struck steps they fire.  Whether the
// rows share one parameter row or each reads its own copy moves a launch
// by 2-3%.
//
// What the design does about that.  One thread a row (a warp a row in the
// slot instances, see below), with the row's whole state and parameter
// row in registers for the launch: the race's inputs
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
//
// The slot instances.  The slot lane does not fit a thread's registers: it
// is up to a few hundred slots a row (128 for the Table-I cluster's repair
// families, every server at the physical cap), and each step needs its
// minimum, the first index of that minimum, a decrement of every slot, the
// first free slot and one write.  So a slot instance runs a warp a row:
// every lane runs the row's scalar step on the same inputs, so every lane
// holds the same values and takes the same branches with no broadcast,
// and the slots are spread over the lanes (slot j on lane j % 32) in
// shared memory, the remaining time as a float and the class and stage
// packed in an int (cls | stage << 16), staged from the state tensors at
// the launch's start and written back at its end.  The minimum and its
// first index come from a 5-step xor-shuffle reduction over each lane's
// own minimum (ties to the lower index, as torch.argmin); the decrement is
// each lane's own slots minus dt in float32, every slot every step, as the
// plain step does it (a deadline kept instead would round differently);
// the first free slot is a ballot over the +inf slots of each group of 32
// and __ffs; the lane that owns the written slot writes it.  A block is one
// row (kernels/ctmc_chunk.py's slot_plan): at 160-168 registers the
// register file, not shared memory, bounds the rows an SM holds (12), and
// one-warp blocks fill it to that bound.  So the sweep's 4,096 rows run in
// about 2.6 rounds of 64 dependent steps; on an H100 a launch took
// 0.37-0.55 ms (PERF.md), some 80x its bound.
//
// The wide instances.  Three shapes do not fit the standard instances'
// staging: an empirical failure or repair hazard of more than kMaxSegments
// segments (the standard launch checks the count), a histogram of more
// edges than one block's shared memory holds, and a slot lane wider than
// it (the wrapper's slot_plan).  The reference's engine takes all three.
// Each instance has a wide twin (its code | kWideBit), built from this
// source with -DCTMC_WIDE into a library of its own (kernels/
// ctmc_chunk.py's LIBRARY_WIDE, and LIBRARY_WIDE64 for float64 age); every
// difference is behind CTMC_WIDE, so the standard libraries compile the
// very tokens they did.  A wide instance takes any segment count from 2
// (the segment loops already run over a runtime m and read the parameter
// row), reads the bin edges where they lie in global memory with the same
// guess and search, and works a slot lane in place in the state's own
// tensors, slot j by lane j % 32 as in shared memory, every operation in
// the same order, so its bits are the standard instance's (and the plain
// step's) on any shape both take.  It stages nothing in shared memory, so
// nothing bounds a row's slots or edges but the tensors.  Its cost is the
// slot lane's traffic: each step reads and writes every slot through the
// L1 and L2 caches instead of shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "event_race.cuh"
#include "log_ndtr.cuh"
#include "ndtri.cuh"

// The type of the failure-age and repair-slot lanes of this library's
// instances: float, or double for the float64 twins.
#ifndef CTMC_AGE_T
#define CTMC_AGE_T float
#endif

#if !defined(__CUDACC__) && !defined(__noinline__)
#define __noinline__
#endif
#if !defined(__CUDACC__) && !defined(CTMC_HOST_WARP)
// A host build of this file with one thread a row and no warp
// (scripts/torch_chunk_host_check.py) never launches a slot instance;
// these stand-ins keep it compiling.
inline float __shfl_xor_sync(unsigned, float v, int) { return v; }
inline double __shfl_xor_sync(unsigned, double v, int) { return v; }
inline int __shfl_xor_sync(unsigned, int v, int) { return v; }
inline unsigned __ballot_sync(unsigned, int p) { return p ? 1u : 0u; }
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline void __syncwarp() {}
#endif

namespace {

constexpr int kThreads = 32;
constexpr int kExp = 16;
constexpr int32_t kCompute = 0, kOverhead = 1, kStall = 2, kDone = 3;

// Failure families, in the order of core/hazards.py's HAZARD_KINDS.
enum Kind { kExponential, kWeibull, kBathtub, kLognormal, kEmpirical };
// Repair families, in the order of core/hazards.py's REPAIR_KINDS.
enum RepairKind { kRepExponential, kRepWeibull, kRepLognormal,
                  kRepDeterministic, kRepEmpirical };
// An instance's template code: the failure family, plus kSlotBit for the
// slot instance of a non-exponential repair family or kScenBit for the
// scenario instance of a fault-domain scenario (never both), plus kWideBit
// in the wide library (-DCTMC_WIDE), which holds the wide twins only.
constexpr int kSlotBit = 8;
constexpr int kScenBit = 16;
constexpr int kWideBit = 32;
constexpr unsigned kFullMask = 0xffffffffu;
// Empirical segments a clock the standard instances take (kernels/
// ctmc_chunk.py's MAX_SEGMENTS); the wide ones take any count from 2.
constexpr int kMaxSegments = 64;
// PyTorch casts a Python float scalar to the tensor's float32; these
// literals round to the same float32 values (1e-9 and 1e-30 both).
constexpr float kMinDiv = 1e-9f;
constexpr float kMinTotal = 1e-30f;
// the plain step's 1e-6 thresholds of integer-valued counts
constexpr float kTiny = static_cast<float>(1e-6);

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
  float* lane[kNLane];      // (B,) float32 lanes; lane[kAge] holds AgeT
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
  // the repair-slot lane of a non-exponential repair family; null and 0
  // for exponential repairs
  float* repair_rem;        // (B, n_slots) remaining time (AgeT), +inf
                            // if free
  int32_t* repair_cls;      // (B, n_slots)
  int32_t* repair_stage;    // (B, n_slots) 0 automated, 1 manual
  float* n_repair_overflow; // (B,)
  int32_t rkind;            // repair family (RepairKind)
  int32_t n_rseg;           // empirical repair segment count, else 0
  int32_t n_slots;          // slot lane width
  // a fault-domain scenario's lanes (kernels/ctmc_chunk.py's SCEN_LANES
  // and SCEN_METRICS); null and 0 without a scenario
  float* deficit;             // (B,) replacements still owed
  float* domain_shocks;       // (B, n_dom); null when n_dom == 0
  int32_t* camp_idx;          // (B,) next schedule entry; null if n_camp 0
  float* maint;               // (B,) 1 in a maintenance window; null when
                              // the schedule has no window
  float* scen_metric[3];      // n_domain_shocks, n_shock_killed,
                              // n_campaign_events
  const int32_t* camp_codes;  // (n_camp,) schedule codes (KILL 0,
                              // MAINT_START 1, MAINT_END 2)
  int32_t n_dom;              // fault domains D
  int32_t n_camp;             // schedule entries L
  int32_t scen;               // 1: a scenario instance
};

namespace {

__device__ __forceinline__ float f(bool b) { return b ? 1.0f : 0.0f; }

// max and pow in the age lane's type T (float or double), as PyTorch's
// float and double kernels call them.
template <typename T>
__device__ __forceinline__ T age_max(T a, T b) {
  if constexpr (sizeof(T) == sizeof(float)) {
    return fmaxf(a, b);
  } else {
    return fmax(a, b);
  }
}
template <typename T>
__device__ __forceinline__ T age_pow(T a, T b) {
  if constexpr (sizeof(T) == sizeof(float)) {
    return powf(a, b);
  } else {
    return pow(a, b);
  }
}

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

// ---- a shock or scripted kill, as core/vectorized.py's scen branches -------

// x > 0 ? x : +0 (vectorized._pos): one bit pattern for every zero.
__device__ __forceinline__ float pos0(float x) { return x > 0.0f ? x : 0.0f; }

// vectorized._syscomp: systematic rounding of the per-class target tgt
// with one uniform, the cumsum left to right.
__device__ __forceinline__ void syscomp(float (&n)[4], const float (&tgt)[4],
                                        float uu) {
  float c = 0.0f, c_prev = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    c = j == 0 ? tgt[0] : c + tgt[j];
    n[j] = pos0(ceilf(c - uu)) - pos0(ceilf(c_prev - uu));
    c_prev = c;
  }
}

// vectorized._take: a bulk take of t of the tot servers of a pool.
__device__ __forceinline__ void take(float (&n)[4], const float (&cnt)[4],
                                     float t, float tot, float uu) {
  const float ratio = t / fmaxf(tot, 1.0f);
  float tgt[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) tgt[j] = cnt[j] * ratio;
  syscomp(n, tgt, uu);
}

// torch.remainder(x, 1.0) on CUDA: fmod, then the divisor added where the
// signs differ (PyTorch's remainder kernel for floating types).
__device__ __forceinline__ float remainder1(float x) {
  float m = fmodf(x, 1.0f);
  if (m != 0.0f && ((1.0f < 0.0f) != (m < 0.0f))) m += 1.0f;
  return m;
}

// A row's pools through a struck step: read before, written after.
struct BulkPools {
  float run[4], sb[4], fw[4], fs[4], aut[4];
};
// What the rest of the step reads of a struck step.
struct BulkSizes {
  float k_run, k_killed, t_sb, t_fw, t_fs, shortfall;
};

// The struck step of the plain step, in its operations and order: the
// kill of a rounded `frac` of every pool (u_diag, u_wrong, u_cls, u_esc),
// the in-shop re-breaks counted (u_succ), the standby -> working -> spare
// refill of the running block (u_pool and its golden-ratio shifts), and the
// pools after the bulk move.  Out of line: it runs on shock and kill steps
// only, and keeps its ~80 values out of the hot loop's registers.
__device__ __noinline__ BulkSizes bulk_kill(BulkPools* p, float man_total,
                                            float frac, float u_diag,
                                            float u_wrong, float u_cls,
                                            float u_esc, float u_succ,
                                            float u_pool) {
  // float32(0.6180339887498949) and float32(2 * 0.6180339887498949), as
  // PyTorch casts the Python scalars
  constexpr float kPhi = static_cast<float>(0.6180339887498949);
  constexpr float kPhi2 = static_cast<float>(2.0 * 0.6180339887498949);
  float tgt[4], rm_run[4], rm_sb[4], rm_fw[4], rm_fs[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) tgt[j] = p->run[j] * frac;
  syscomp(rm_run, tgt, u_diag);
#pragma unroll
  for (int j = 0; j < 4; ++j) tgt[j] = p->sb[j] * frac;
  syscomp(rm_sb, tgt, u_wrong);
#pragma unroll
  for (int j = 0; j < 4; ++j) tgt[j] = p->fw[j] * frac;
  syscomp(rm_fw, tgt, u_cls);
#pragma unroll
  for (int j = 0; j < 4; ++j) tgt[j] = p->fs[j] * frac;
  syscomp(rm_fs, tgt, u_esc);
  BulkSizes z;
  z.k_run = ((rm_run[0] + rm_run[1]) + rm_run[2]) + rm_run[3];
  const float k_sb = ((rm_sb[0] + rm_sb[1]) + rm_sb[2]) + rm_sb[3];
  const float k_fw = ((rm_fw[0] + rm_fw[1]) + rm_fw[2]) + rm_fw[3];
  const float k_fs = ((rm_fs[0] + rm_fs[1]) + rm_fs[2]) + rm_fs[3];
  const float shop = fmaxf(
      (((p->aut[0] + p->aut[1]) + p->aut[2]) + p->aut[3]) + man_total, 0.0f);
  const float x = shop * frac;
  const float x_fl = floorf(x);
  const float k_shop = x_fl + (u_succ < x - x_fl ? 1.0f : 0.0f);
  z.k_killed = (((z.k_run + k_sb) + k_fw) + k_fs) + k_shop;
  const float sb_rem =
      fmaxf((((p->sb[0] + p->sb[1]) + p->sb[2]) + p->sb[3]) - k_sb, 0.0f);
  const float fw_rem =
      fmaxf((((p->fw[0] + p->fw[1]) + p->fw[2]) + p->fw[3]) - k_fw, 0.0f);
  const float fs_rem =
      fmaxf((((p->fs[0] + p->fs[1]) + p->fs[2]) + p->fs[3]) - k_fs, 0.0f);
  z.t_sb = fminf(z.k_run, sb_rem);
  z.t_fw = fminf(z.k_run - z.t_sb, fw_rem);
  z.t_fs = fminf((z.k_run - z.t_sb) - z.t_fw, fs_rem);
  z.shortfall = fmaxf(((z.k_run - z.t_sb) - z.t_fw) - z.t_fs, 0.0f);
  float cnt[4], mv_sb[4], mv_fw[4], mv_fs[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) cnt[j] = p->sb[j] - rm_sb[j];
  take(mv_sb, cnt, z.t_sb, sb_rem, u_pool);
#pragma unroll
  for (int j = 0; j < 4; ++j) cnt[j] = p->fw[j] - rm_fw[j];
  take(mv_fw, cnt, z.t_fw, fw_rem, remainder1(u_pool + kPhi));
#pragma unroll
  for (int j = 0; j < 4; ++j) cnt[j] = p->fs[j] - rm_fs[j];
  take(mv_fs, cnt, z.t_fs, fs_rem, remainder1(u_pool + kPhi2));
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p->run[j] = (((p->run[j] - rm_run[j]) + mv_sb[j]) + mv_fw[j]) + mv_fs[j];
    p->sb[j] = (p->sb[j] - rm_sb[j]) - mv_sb[j];
    p->fw[j] = (p->fw[j] - rm_fw[j]) - mv_fw[j];
    p->fs[j] = (p->fs[j] - rm_fs[j]) - mv_fs[j];
    p->aut[j] = (((p->aut[j] + rm_run[j]) + rm_sb[j]) + rm_fw[j]) + rm_fs[j];
  }
  return z;
}

// ---- repair quantiles, as core/hazards.py's REPAIR_SAMPLERS draw them ------

// piecewise_conditional_residual from age 0 with exp_draw = -log1p(-u):
// the cumulative hazard's segment sums left to right, as in the plain step
// (m - 1 edges e, m rates r).
__device__ __forceinline__ float piecewise_quantile(float u, const float* e,
                                                    const float* r, int m) {
  const float exp_draw = -log1pf(-u);
  float h_age = 0.0f;
  for (int j = 0; j < m; ++j) {
    const float lo = j == 0 ? 0.0f : __ldg(e + j - 1);
    const float hi = j == m - 1 ? INFINITY : __ldg(e + j);
    const float term = __ldg(r + j) * fminf(fmaxf(0.0f - lo, 0.0f), hi - lo);
    h_age = j == 0 ? term : h_age + term;
  }
  const float target = h_age + exp_draw;
  // idx = #{j : cs_j <= target} over the nondecreasing segment sums cs,
  // and c_prev = cs_{idx - 1}
  float cs = 0.0f, c_prev = 0.0f;
  int idx = 0;
  for (int j = 0; j < m; ++j) {
    const float lo = j == 0 ? 0.0f : __ldg(e + j - 1);
    const float hi = j == m - 1 ? INFINITY : __ldg(e + j);
    const float rj = __ldg(r + j);
    const float seg = rj > 0.0f ? rj * (hi - lo) : 0.0f;
    cs = j == 0 ? seg : cs + seg;
    if (cs <= target) {
      idx += 1;
      c_prev = cs;
    }
  }
  if (idx >= m) return INFINITY;   // a zero-rate tail exhausts the hazard
  const float lo_j = idx == 0 ? 0.0f : __ldg(e + idx - 1);
  const float t_star = lo_j + (target - c_prev)
                              / fmaxf(__ldg(r + idx), kMinTotal);
  return fmaxf(t_star - 0.0f, 0.0f);
}

// The repair family's inverse CDF at u for a stage: scale and shape are
// the stage's closed-form columns, e and r its empirical (edges, rates).
__device__ __noinline__ float repair_quantile(int rkind, float u, float scale,
                                              float shape, const float* e,
                                              const float* r, int m) {
  switch (rkind) {
    case kRepWeibull: {
      const float q = scale * powf(-log1pf(-u), 1.0f / shape);
      return scale > 0.0f ? q : INFINITY;
    }
    case kRepLognormal: {
      const float q = scale * expf(shape * ndtri(u));
      return scale > 0.0f ? q : INFINITY;
    }
    case kRepDeterministic:
      return scale * 1.0f;
    default:
      return piecewise_quantile(u, e, r, m);
  }
}

// The bin edges, and slot idx's cls | stage << 16: staged in shared
// memory, or read where they lie by a wide instance.
#ifdef CTMC_WIDE
#define CTMC_EDGES a.hist_edges
#define CTMC_META_AT(idx) (g_cls[idx] | (g_stage[idx] << 16))
#else
#define CTMC_EDGES s_edges
#define CTMC_META_AT(idx) s_meta[idx]
#endif

template <int kKind, typename AgeT>
__global__ void __launch_bounds__(kThreads)
    ctmc_chunk_kernel(const CtmcChunkArgs a) {
  // the failure family, and whether this is a slot or a scenario instance
  constexpr int kFamily = kKind & ~(kSlotBit | kScenBit | kWideBit);
  constexpr bool kSlots = (kKind & kSlotBit) != 0;
  constexpr bool kScen = (kKind & kScenBit) != 0;
  static_assert(!(kSlots && kScen), "a scenario runs exponential repairs");
  constexpr bool kExpOnly = kFamily == kExponential;
  // residuals raced: [the slot lane's | the campaign's,] completion, timer,
  // [the family's,] checkpoint write
  constexpr int kRoff = kSlots || kScen ? 1 : 0;
  constexpr int kDet = (kExpOnly ? 3 : 4) + kRoff;
  // uniforms a step: 8, u_haz for a non-exponential failure family, u_dur
  // for a slot instance
  constexpr int kNU = 8 + (kExpOnly ? 0 : 1) + (kSlots ? 1 : 0);
  extern __shared__ float s_edges[];
#ifndef CTMC_WIDE
  for (int i = threadIdx.x; i < a.n_edges; i += blockDim.x) {
    s_edges[i] = a.hist_edges[i];
  }
  __syncthreads();
#endif
  // the bin guess's scale (only a guess: bin_index checks it)
  const float lg0 = a.n_edges > 0 ? __log2f(CTMC_EDGES[0]) : 0.0f;
  const float lg_span =
      a.n_edges > 1 ? __log2f(CTMC_EDGES[a.n_edges - 1]) - lg0 : 0.0f;
  const float inv_step = a.n_edges > 1 ? (a.n_edges - 1) / lg_span : 0.0f;

  // a slot instance's block is one row, a warp; the others' a row a thread
  int64_t b;
  int lane = 0;
  if constexpr (kSlots) {
    b = blockIdx.x;
    lane = static_cast<int>(threadIdx.x);
  } else {
    b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  }
  if (b >= a.n_rows) return;
  int32_t phase = a.phase[b];
  if (phase == kDone || a.n_steps == 0) return;   // inert: nothing changes

  // the row's slots in shared memory, after the bin edges (padded to 16
  // bytes): remaining time (AgeT), then cls | stage << 16
  const int n_slots = a.n_slots;
  AgeT* s_rem = nullptr;
#ifndef CTMC_WIDE
  int32_t* s_meta = nullptr;
#endif
  float overflow = 0.0f;
  AgeT* const repair_rem = reinterpret_cast<AgeT*>(a.repair_rem);
#ifdef CTMC_WIDE
  // a wide instance works them in place in the state tensors, slot j by
  // lane j % 32 as in shared memory
  int32_t* g_cls = nullptr;
  int32_t* g_stage = nullptr;
  if constexpr (kSlots) {
    s_rem = repair_rem + b * n_slots;
    g_cls = a.repair_cls + b * n_slots;
    g_stage = a.repair_stage + b * n_slots;
    overflow = a.n_repair_overflow[b];
  }
#else
  if constexpr (kSlots) {
    s_rem = reinterpret_cast<AgeT*>(s_edges + ((a.n_edges + 3) & ~3));
    s_meta = reinterpret_cast<int32_t*>(s_rem + n_slots);
    for (int j = lane; j < n_slots; j += 32) {
      s_rem[j] = repair_rem[b * n_slots + j];
      s_meta[j] = a.repair_cls[b * n_slots + j]
                  | (a.repair_stage[b * n_slots + j] << 16);
    }
    overflow = a.n_repair_overflow[b];
    __syncwarp();
  }
#endif

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
  const float hz0 = kExpOnly || kFamily == kEmpirical ? 0.0f : p[16];
  const float hz1 = kExpOnly || kFamily == kEmpirical ? 0.0f : p[17];
  const float hz2 = kExpOnly || kFamily == kEmpirical ? 0.0f : p[18];
  const float hz3 = kExpOnly || kFamily == kEmpirical ? 0.0f : p[19];
  const float hz4 = kExpOnly || kFamily == kEmpirical ? 0.0f : p[20];
  const int n_seg = a.n_seg;
  const float* e_re = p + 16;
  const float* e_rr = e_re + (n_seg - 1);
  const float* e_se = e_rr + n_seg;
  const float* e_sr = e_se + (n_seg - 1);
  // Weibull: 1 / k as PyTorch's reciprocal gives it; lognormal: log(sigma)
  const float inv_k = kFamily == kWeibull ? 1.0f / hz2 : 0.0f;
  const float log_sigma = kFamily == kLognormal ? logf(hz2) : 0.0f;
  // the repair family's columns (repair_columns) after the hazard block:
  // [auto scale, manual scale, shape], or the empirical [auto edges (m-1),
  // auto rates (m), manual edges (m-1), manual rates (m)], m = n_rseg
  const float* rp = p + 16 + (kFamily == kEmpirical ? 4 * n_seg - 2 : 5);
  const int n_rseg = a.n_rseg;
  // a scenario's columns after the exponential repair block (scenario_
  // columns): [shock rates (D), fleet fractions (D), entry times (L), kill
  // fractions (L), target domains (L)]; a kill needs only its fraction, so
  // the target domains are not read.  The race's exponential lanes are the
  // 16 and then the D shock lanes: kx of them.
  const int n_dom = kScen ? a.n_dom : 0;
  const int n_camp = kScen ? a.n_camp : 0;
  const float* shock_rate = rp + 3;
  const float* dom_frac = shock_rate + n_dom;
  const float* camp_t = dom_frac + n_dom;
  const float* camp_frac = camp_t + n_camp;
  const int kx = kExp + n_dom;

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
  AgeT* const age_lane = reinterpret_cast<AgeT*>(a.lane[kAge]);
  AgeT age = age_lane[b];
  float cur_run = a.lane[kCurRun][b];
  float ckpt_work = a.lane[kCkptWork][b], in_ckpt = a.lane[kInCkpt][b];
  int32_t n_runs = a.n_runs[b];
  float m[kNMetric];
#pragma unroll
  for (int i = 0; i < kNMetric; ++i) m[i] = a.metric[i][b];
  // a scenario's lanes: the deficit, the schedule pointer, the window flag
  // and the three counters
  float deficit = 0.0f, maint = 0.0f;
  int32_t camp_idx = 0;
  float n_shocks = 0.0f, n_killed = 0.0f, n_camp_events = 0.0f;
  if constexpr (kScen) {
    deficit = a.deficit[b];
    if (n_camp > 0) camp_idx = a.camp_idx[b];
    if (a.maint != nullptr) maint = a.maint[b];
    n_shocks = a.scen_metric[0][b];
    n_killed = a.scen_metric[1][b];
    n_camp_events = a.scen_metric[2][b];
  }

  // the repair rates aut[j] / auto_div and man[j] / man_div, kept
  // divided: a step changes at most one class of each pool, and only that
  // class is divided again (a slot instance's repair clocks carry none)
  float q_aut[4], q_man[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    q_aut[j] = kSlots ? 0.0f : aut[j] / auto_div;
    q_man[j] = kSlots ? 0.0f : man[j] / man_div;
  }

  // the next step's uniforms, loaded before this step's arithmetic: two
  // float4s of an 8-float row, nine or ten floats of a longer row
  const float4* ub = reinterpret_cast<const float4*>(a.us) + 2 * (b % a.R);
  const int64_t u_step = 2 * a.R_draw;             // float4s a step
  const float* ub9 = a.us + kNU * (b % a.R);
  const int64_t u_step9 = kNU * a.R_draw;          // floats a step
  constexpr bool kVecU = kExpOnly && !kSlots;
  float4 n0, n1;
  float n8 = 0.0f, n9 = 0.0f;
  if constexpr (kVecU) {
    n0 = __ldg(ub);
    n1 = __ldg(ub + 1);
  } else {
    n0 = make_float4(__ldg(ub9), __ldg(ub9 + 1), __ldg(ub9 + 2),
                     __ldg(ub9 + 3));
    n1 = make_float4(__ldg(ub9 + 4), __ldg(ub9 + 5), __ldg(ub9 + 6),
                     __ldg(ub9 + 7));
    n8 = __ldg(ub9 + 8);
    if constexpr (kNU > 9) n9 = __ldg(ub9 + 9);
  }

  for (int k = 0; k < a.n_steps; ++k) {
    // u_time, u_pick, u_diag, u_wrong | u_cls, u_esc, u_succ, u_pool
    // [| u_haz] [| u_dur]
    const float4 u0 = n0, u1 = n1;
    const float u_haz = n8;
    const float u_dur = kNU > 9 ? n9 : n8;
    if (k + 1 < a.n_steps) {
      if constexpr (kVecU) {
        n0 = __ldg(ub + (k + 1) * u_step);
        n1 = __ldg(ub + (k + 1) * u_step + 1);
      } else {
        const float* un = ub9 + (k + 1) * u_step9;
        n0 = make_float4(__ldg(un), __ldg(un + 1), __ldg(un + 2),
                         __ldg(un + 3));
        n1 = make_float4(__ldg(un + 4), __ldg(un + 5), __ldg(un + 6),
                         __ldg(un + 7));
        n8 = __ldg(un + 8);
        if constexpr (kNU > 9) n9 = __ldg(un + 9);
      }
    }

    const bool computing = phase == kCompute;
    const bool in_overhead = phase == kOverhead;
    const bool stalled = phase == kStall;
    const bool active = phase != kDone;
    const bool in_ckpt_flag = in_ckpt > 0.0f;
    // the thinning families' hazards read the float view of the age
    const float age32 = static_cast<float>(age);

    // ---- the slot lane's minimum and its first index --------------------
    AgeT slot_min = INFINITY;
    int slot_arg = 0;
    if constexpr (kSlots) {
      AgeT v = INFINITY;
      int vi = 0x7fffffff;
      for (int j = lane; j < n_slots; j += 32) {
        const AgeT r = s_rem[j];
        if (r < v) {
          v = r;
          vi = j;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const AgeT ov = __shfl_xor_sync(kFullMask, v, off);
        const int oi = __shfl_xor_sync(kFullMask, vi, off);
        if (ov < v || (ov == v && oi < vi)) {
          v = ov;
          vi = oi;
        }
      }
      slot_min = v;
      slot_arg = vi == 0x7fffffff ? 0 : vi;   // every slot free: argmin 0
    }

    // ---- rates and residuals -------------------------------------------
    float rates[kExp];
    float resid[kDet];
    // the family's state of this step: the Weibull hazard shares and
    // their sum, the bathtub majorant, the lognormal / empirical
    // majorants of the random and systematic clocks
    float w8[8], w_total = 0.0f, g_bar = 0.0f, hbar_r = 0.0f, hbar_s = 0.0f;
    if constexpr (kFamily == kWeibull) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float bad = f(j % 2 == 1);
        w8[j] = (run[j] * hz0) * f(computing);
        w8[4 + j] = ((run[j] * bad) * hz1) * f(computing);
      }
      w_total = w8[0];
#pragma unroll
      for (int j = 1; j < 8; ++j) w_total += w8[j];
      // in the age lane's type: E and C cast up, the residual rounded to
      // float for the race
      float s = INFINITY;
      if (w_total > 0.0f) {
        const AgeT target =
            age_pow(age, static_cast<AgeT>(hz2))
            + static_cast<AgeT>(-logf(u_haz))
                  / age_max(static_cast<AgeT>(w_total),
                            static_cast<AgeT>(1e-30));
        s = static_cast<float>(
            age_max(age_pow(target, static_cast<AgeT>(inv_k)) - age,
                    static_cast<AgeT>(0)));
      }
      resid[kRoff + 2] = s;
    } else if constexpr (kFamily == kBathtub) {
      g_bar = fmaxf(bathtub_g(age32, hz0, hz1, hz2, hz3),
                    bathtub_g(age32 + hz4, hz0, hz1, hz2, hz3));
      resid[kRoff + 2] = computing ? hz4 : INFINITY;
    } else if constexpr (kFamily == kLognormal) {
      hbar_r = lognormal_bar(age32, hz4, hz0, hz2, log_sigma, hz3);
      hbar_s = lognormal_bar(age32, hz4, hz1, hz2, log_sigma, hz3);
      resid[kRoff + 2] = computing ? (hz4 > 0.0f ? hz4 : INFINITY)
                                   : INFINITY;
    } else if constexpr (kFamily == kEmpirical) {
      hbar_r = piecewise_h(age32, e_re, e_rr, n_seg);
      hbar_s = piecewise_h(age32, e_se, e_sr, n_seg);
      resid[kRoff + 2] = computing ? fminf(piecewise_gap(age32, e_re, n_seg),
                                           piecewise_gap(age32, e_se, n_seg))
                                   : INFINITY;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bad = f(j % 2 == 1);
      if constexpr (kExpOnly) {
        rates[j] = ((run[j] * r_rand) * f(computing)) * f(active);
        rates[4 + j] = (((run[j] * bad) * r_sys) * f(computing)) * f(active);
      } else if constexpr (kFamily == kWeibull) {
        rates[j] = 0.0f;
        rates[4 + j] = 0.0f;
      } else if constexpr (kFamily == kBathtub) {
        rates[j] = (((run[j] * r_rand) * g_bar) * f(computing)) * f(active);
        rates[4 + j] = ((((run[j] * bad) * r_sys) * g_bar) * f(computing))
                       * f(active);
      } else {
        rates[j] = ((run[j] * hbar_r) * f(computing)) * f(active);
        rates[4 + j] = (((run[j] * bad) * hbar_s) * f(computing))
                       * f(active);
      }
      if constexpr (kScen) {
        // a maintenance window gates the repair clocks to zero
        rates[8 + j] = (maint == 0.0f ? q_aut[j] : 0.0f) * f(active);
        rates[12 + j] = (maint == 0.0f ? q_man[j] : 0.0f) * f(active);
      } else {
        rates[8 + j] = q_aut[j] * f(active);
        rates[12 + j] = q_man[j] * f(active);
      }
    }
    if constexpr (kSlots) {
      resid[0] = active ? static_cast<float>(slot_min) : INFINITY;
    }
    // the campaign's next entry, raced first
    const bool camp_pending = kScen && active && camp_idx < n_camp;
    const int ci = min(max(camp_idx, 0), max(n_camp - 1, 0));
    if constexpr (kScen) {
      resid[0] = camp_pending ? fmaxf(__ldg(camp_t + ci) - t, 0.0f)
                              : INFINITY;
    }
    resid[kRoff] = computing ? work_left : INFINITY;
    resid[kRoff + 1] = in_overhead ? timer : INFINITY;
    resid[kDet - 1] = (computing && ckpt > 0.0f)
                          ? fmaxf(ckpt - ckpt_work, 0.0f)
                          : INFINITY;
    float dt;
    int32_t ev;
    // a scenario's D shock lanes (a row's own parameter columns, alike for
    // every row of a point) follow the 16; n_dom is 0 at compile time
    // in the scenario-free instances
    event_race_row(rates, kExp, shock_rate, n_dom, resid, kDet, u0.x, u0.y,
                   &dt, &ev);
    dt = (active && isfinite(dt)) ? dt : 0.0f;

    int32_t cls = ev % 4;
    bool is_fail = active && ev < 8;
    bool is_sys = active && ev >= 4 && ev < 8;
    if constexpr (kFamily == kWeibull) {
      // the failure arrives on the hazard residual; the failing channel
      // is picked from the hazard shares with u_pick
      const bool haz_fail = active && ev == kx + kRoff + 2;
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
    } else if constexpr (kFamily == kBathtub) {
      if (is_fail) {
        const bool accept =
            u_haz * g_bar < bathtub_g(age32 + dt, hz0, hz1, hz2, hz3);
        is_fail = accept;
        is_sys = is_sys && accept;
      }
    } else if constexpr (kFamily == kLognormal) {
      if (is_fail) {
        const bool cand_sys = ev >= 4;
        const float h_at = lognormal_h(age32 + dt, cand_sys ? hz1 : hz0,
                                       hz2, log_sigma);
        const bool accept = u_haz * (cand_sys ? hbar_s : hbar_r) < h_at;
        is_fail = accept;
        is_sys = is_sys && accept;
      }
    } else if constexpr (kFamily == kEmpirical) {
      if (is_fail) {
        const bool cand_sys = ev >= 4;
        const float h_at =
            cand_sys ? piecewise_h(age32 + dt, e_se, e_sr, n_seg)
                     : piecewise_h(age32 + dt, e_re, e_rr, n_seg);
        const bool accept = u_haz * (cand_sys ? hbar_s : hbar_r) <= h_at;
        is_fail = accept;
        is_sys = is_sys && accept;
      }
    }
    // a slot's repair completed: its class and stage decide the completion
    const bool is_rep = kSlots && active && ev == kx;
    int32_t won_meta = 0;
#ifdef CTMC_WIDE
    if constexpr (kSlots) {
      won_meta = g_cls[slot_arg] | (g_stage[slot_arg] << 16);
    }
#else
    if constexpr (kSlots) won_meta = s_meta[slot_arg];
#endif
    if (is_rep) cls = won_meta & 0xffff;
    const bool is_auto = kSlots ? is_rep && (won_meta >> 16) == 0
                                : active && ev >= 8 && ev < 12;
    const bool is_man = kSlots ? is_rep && (won_meta >> 16) == 1
                               : active && ev >= 12 && ev < 16;
    const bool is_complete = active && ev == kx + kRoff;
    const bool is_timer = active && ev == kx + kRoff + 1;
    const bool is_ckpt = active && ev == kx + kDet - 1;

    // ---- a shock or a campaign entry ---------------------------------------
    // shock lanes [16, kx), the campaign on the first residual; a struck
    // step sizes its kill and refill out of line, on the uniforms the
    // failure path leaves idle
    const bool is_shock = kScen && active && ev >= kExp && ev < kx;
    const bool is_camp = kScen && camp_pending && ev == kx;
    int32_t code = -1;
    if (is_camp) code = __ldg(a.camp_codes + ci);
    const bool is_kill = is_camp && code == 0;
    const bool struck = is_shock || is_kill;
    BulkPools pools;
    BulkSizes bulk{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (kScen && struck) {
      const float frac = is_shock ? __ldg(dom_frac + (ev - kExp))
                                  : __ldg(camp_frac + ci);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pools.run[j] = run[j];
        pools.sb[j] = sb[j];
        pools.fw[j] = fw[j];
        pools.fs[j] = fs[j];
        pools.aut[j] = aut[j];
      }
      bulk = bulk_kill(&pools, sum4(man), frac, u0.z, u0.w, u1.x, u1.y,
                       u1.z, u1.w);
    }
    const bool sh_affects = struck && bulk.k_run > 0.0f;
    const bool sh_resolves = sh_affects && bulk.shortfall <= kTiny
                             && !stalled;
    const bool sh_stalls = sh_affects && !sh_resolves;
    const float shock_timer =
        (recovery + (bulk.t_fw + bulk.t_fs > kTiny ? host_sel : 0.0f))
        + (bulk.t_fs > kTiny ? waiting + preempt_cost : 0.0f);

    const float t_new = t + dt;

    // ---- progress accounting -------------------------------------------
    // a failure, or a shock that guts the running block while it computes
    // or writes a checkpoint, rolls back to the last checkpoint
    const bool rollback =
        is_fail || (sh_affects && (computing || in_ckpt_flag));
    const float progress = computing ? dt : 0.0f;
    const float new_ckpt_work = ckpt_work + progress;
    const float lost = (rollback && ckpt > 0.0f) ? new_ckpt_work : 0.0f;
    const float banked = progress - lost;
    work_left = work_left - banked;
    m[kUsefulWork] = m[kUsefulWork] + banked;
    m[kLostWork] = m[kLostWork] + lost;
    ckpt_work = (rollback || is_ckpt || is_complete) ? 0.0f : new_ckpt_work;

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
    const bool record = rollback || is_complete;
    const float run_val = cur_run + progress;
    if (record && a.max_runs > 0 && (!kSlots || lane == 0)) {
      a.run_durations[b * a.max_runs + n_runs % a.max_runs] = run_val;
    }
    n_runs += record ? 1 : 0;
    cur_run = record ? 0.0f : run_val;

    // ---- phase age ------------------------------------------------------
    age = (is_timer && !in_ckpt_flag) ? static_cast<AgeT>(0)
                                      : age + static_cast<AgeT>(progress);

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
    // the deficit: the job restarts once the whole struck block is back
    bool unstall = to_stalled;
    if constexpr (kScen) {
      deficit = (deficit + (goes_stall ? 1.0f : 0.0f))
                + (struck ? bulk.shortfall : 0.0f);
      deficit = to_stalled ? fmaxf(deficit - 1.0f, 0.0f) : deficit;
      unstall = to_stalled && deficit <= kTiny;
    }
    phase_n = unstall ? kOverhead : phase_n;
    timer_n = unstall ? recovery : timer_n;
    m[kStallTime] = m[kStallTime] + (unstall ? t_new - stall_start : 0.0f);
    m[kRecoveryOverhead] = recovery_oh + (unstall ? recovery : 0.0f);

    // ---- a shock's or a campaign entry's execution -------------------------
    float stall_start_s = stall_start_n;
    if constexpr (kScen) {
      n_shocks = n_shocks + f(is_shock);
      n_camp_events = n_camp_events + f(is_camp);
      n_killed = n_killed + (struck ? bulk.k_killed : 0.0f);
      m[kNStandbySwaps] = m[kNStandbySwaps] + (struck ? bulk.t_sb : 0.0f);
      m[kNHostSelections] = m[kNHostSelections]
                            + (struck ? bulk.t_fw + bulk.t_fs : 0.0f);
      m[kNPreemptions] = m[kNPreemptions] + (struck ? bulk.t_fs : 0.0f);
      if (is_shock) {
        float* cell = a.domain_shocks + b * n_dom + (ev - kExp);
        *cell = *cell + 1.0f;
      }
      camp_idx += is_camp ? 1 : 0;
      maint = (is_camp && code == 1) ? 1.0f
                                     : ((is_camp && code == 2) ? 0.0f : maint);
      timer_n = sh_resolves ? shock_timer : timer_n;
      phase_n = sh_resolves ? kOverhead : phase_n;
      phase_n = sh_stalls ? kStall : phase_n;
      // a shock aborts a checkpoint write in flight
      in_ckpt = sh_affects ? 0.0f : in_ckpt;
      stall_start_s = (sh_stalls && !stalled) ? t_new : stall_start_n;
      m[kRecoveryOverhead] = m[kRecoveryOverhead]
                             + (sh_resolves ? recovery : 0.0f);
    }

    // ---- streaming histograms -------------------------------------------
    const bool ended = resolves || unstall || sh_resolves;
    if (a.n_sel > 0 && (record || ended)) {
      const float stall_wait = t_new - stall_start;
      const float downtime =
          sh_resolves ? shock_timer
                      : (resolves ? fail_timer : stall_wait + recovery);
      const float acquire_wait =
          sh_resolves ? shock_timer - recovery
                      : (resolves ? fail_timer - recovery : stall_wait);
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
        if (mask && (!kSlots || lane == 0)) {
          const int idx = bin_index(CTMC_EDGES, a.n_edges, v, lg0, inv_step);
          atomicAdd(a.hist + (b * a.n_sel + c) * (a.n_edges + 1) + idx,
                    1.0f);
        }
      }
    }

    // ---- commit ---------------------------------------------------------
    t = t_new;
    timer = timer_n;
    phase = phase_n;
    stall_start = stall_start_s;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      run[j] = run_n[j];
      sb[j] = sb_n[j];
      fw[j] = fw_n[j];
      fs[j] = fs_n[j];
      aut[j] = aut_n[j];
      man[j] = man_n[j];
    }
    if (!kSlots && (diagnosed || is_auto)) {
      const int ja = is_auto ? cls : (wrong ? p_run : cls);
      const float q = lane_of(aut, ja) / auto_div;
#pragma unroll
      for (int j = 0; j < 4; ++j) q_aut[j] = j == ja ? q : q_aut[j];
    }
    if (!kSlots && (escalate || is_man)) {
      const float q = lane_of(man, cls) / man_div;
#pragma unroll
      for (int j = 0; j < 4; ++j) q_man[j] = j == cls ? q : q_man[j];
    }
    if (kScen && struck) {
      // the pools after the bulk move (the step's own updates leave a
      // struck row's pools as they were), and every automated rate anew
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        run[j] = pools.run[j];
        sb[j] = pools.sb[j];
        fw[j] = pools.fw[j];
        fs[j] = pools.fs[j];
        aut[j] = pools.aut[j];
        q_aut[j] = aut[j] / auto_div;
      }
    }

    // ---- the repair-slot lane ---------------------------------------------
    if constexpr (kSlots) {
      // every slot counts down by dt; the first free slot after that
      int fslot = -1;
      for (int base = 0; base < n_slots; base += 32) {
        const int j = base + lane;
        bool is_free = false;
        if (j < n_slots) {
          const AgeT r =
              active ? s_rem[j] - static_cast<AgeT>(dt) : s_rem[j];
          s_rem[j] = r;
          is_free = isinf(r);
        }
        const unsigned ballot = __ballot_sync(kFullMask, is_free);
        if (fslot < 0 && ballot != 0u) fslot = base + __ffs(ballot) - 1;
      }
      const bool any_free = fslot >= 0;
      const bool entered = diagnosed && any_free;
      const int idx = is_rep ? slot_arg : (any_free ? fslot : 0);
      // entry and escalation never share a step: one draw serves both
      float q_dur = 0.0f;
      if (escalate || entered) {
        const int m_r = n_rseg;
        const float* e_r = escalate ? rp + (2 * m_r - 1) : rp;
        q_dur = repair_quantile(a.rkind, u_dur, escalate ? rp[1] : rp[0],
                                rp[2], e_r, e_r + (m_r - 1), m_r);
      }
      if ((idx & 31) == lane) {
        const int32_t meta = CTMC_META_AT(idx);
        const int32_t rm_cls = wrong ? p_run : cls;
        const int32_t cls_n = entered ? rm_cls : (meta & 0xffff);
        const int32_t stage_n = escalate ? 1 : (entered ? 0 : meta >> 16);
        s_rem[idx] = finishes ? static_cast<AgeT>(INFINITY)
                              : ((escalate || entered)
                                     ? static_cast<AgeT>(q_dur)
                                     : s_rem[idx]);
#ifdef CTMC_WIDE
        g_cls[idx] = cls_n;
        g_stage[idx] = stage_n;
#else
        s_meta[idx] = cls_n | (stage_n << 16);
#endif
      }
      overflow = overflow + f(diagnosed && !any_free);
      __syncwarp();
    }

    // a finished row stays as it is for the rest of the chunk
    if (phase == kDone) break;
  }

  if constexpr (kSlots) {
#ifndef CTMC_WIDE
    for (int j = lane; j < n_slots; j += 32) {
      repair_rem[b * n_slots + j] = s_rem[j];
      a.repair_cls[b * n_slots + j] = s_meta[j] & 0xffff;
      a.repair_stage[b * n_slots + j] = s_meta[j] >> 16;
    }
#endif
    if (lane != 0) return;
    a.n_repair_overflow[b] = overflow;
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
  age_lane[b] = age;
  a.lane[kCurRun][b] = cur_run;
  a.lane[kCkptWork][b] = ckpt_work;
  a.lane[kInCkpt][b] = in_ckpt;
  a.phase[b] = phase;
  a.n_runs[b] = n_runs;
#pragma unroll
  for (int i = 0; i < kNMetric; ++i) a.metric[i][b] = m[i];
  if constexpr (kScen) {
    a.deficit[b] = deficit;
    if (n_camp > 0) a.camp_idx[b] = camp_idx;
    if (a.maint != nullptr) a.maint[b] = maint;
    a.scen_metric[0][b] = n_shocks;
    a.scen_metric[1][b] = n_killed;
    a.scen_metric[2][b] = n_camp_events;
  }
}

}  // namespace

template <int kKind>
static int launch(const CtmcChunkArgs* args, cudaStream_t stream) {
  using AgeT = CTMC_AGE_T;
  constexpr bool kSlots = (kKind & kSlotBit) != 0;
  constexpr bool kWide = (kKind & kWideBit) != 0;
  // a slot instance: a row a block, its slots (sizeof(AgeT) + 4 bytes
  // each) after the bin edges padded to 16 bytes; a wide one stages nothing
  const int rows = kSlots ? 1 : kThreads;
  const size_t smem =
      kWide ? 0
      : kSlots ? static_cast<size_t>((args->n_edges + 3) & ~3) * sizeof(float)
                     + static_cast<size_t>(args->n_slots)
                           * (sizeof(AgeT) + sizeof(int32_t))
               : static_cast<size_t>(args->n_edges) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ctmc_chunk_kernel<kKind, AgeT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (args->n_rows + rows - 1) / rows;
  ctmc_chunk_kernel<kKind, AgeT>
      <<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// Plain-C entry point for ctypes.  `args` points to the launch's struct in
// host memory; `stream` is a cudaStream_t passed as an integer.  Returns
// the first CUDA error of the shared-memory attribute or the launch (0 on
// success), or cudaErrorInvalidValue for a family, segment count, slot
// lane or scenario the kernel does not take; the caller raises on anything
// else.  The wide library (-DCTMC_WIDE) launches the wide twins (kLibBit)
// and takes any segment count from 2.
#ifdef CTMC_WIDE
constexpr int kLibBit = kWideBit;
constexpr int kLibMaxSegments = 0x7fffffff;
#else
constexpr int kLibBit = 0;
constexpr int kLibMaxSegments = kMaxSegments;
#endif
extern "C" int ctmc_chunk_launch(const CtmcChunkArgs* args, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool seg_ok = args->kind == kEmpirical
                          ? args->n_seg >= 2 && args->n_seg <= kLibMaxSegments
                          : args->n_seg == 0;
  const bool slots = args->rkind != kRepExponential;
  const bool rseg_ok =
      args->rkind == kRepEmpirical
          ? args->n_rseg >= 2 && args->n_rseg <= kLibMaxSegments
          : args->n_rseg == 0;
  const bool slots_ok =
      slots ? args->rkind <= kRepEmpirical && args->n_slots >= 1
            : args->rkind == kRepExponential && args->n_slots == 0;
  const bool scen = args->scen != 0;
  const bool scen_ok =
      !scen || (!slots && args->n_dom >= 0 && args->n_camp >= 0
                && args->deficit != nullptr
                && args->scen_metric[0] != nullptr
                && args->scen_metric[1] != nullptr
                && args->scen_metric[2] != nullptr
                && (args->n_dom == 0) == (args->domain_shocks == nullptr)
                && (args->n_camp == 0) == (args->camp_idx == nullptr)
                && (args->n_camp == 0) == (args->camp_codes == nullptr));
  if (!seg_ok || !rseg_ok || !slots_ok || !scen_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (args->kind | (slots ? kSlotBit : 0) | (scen ? kScenBit : 0)) {
    case kExponential:
      return launch<kExponential | kLibBit>(args, s);
    case kWeibull:
      return launch<kWeibull | kLibBit>(args, s);
    case kBathtub:
      return launch<kBathtub | kLibBit>(args, s);
    case kLognormal:
      return launch<kLognormal | kLibBit>(args, s);
    case kEmpirical:
      return launch<kEmpirical | kLibBit>(args, s);
    case kExponential | kSlotBit:
      return launch<kExponential | kSlotBit | kLibBit>(args, s);
    case kWeibull | kSlotBit:
      return launch<kWeibull | kSlotBit | kLibBit>(args, s);
    case kBathtub | kSlotBit:
      return launch<kBathtub | kSlotBit | kLibBit>(args, s);
    case kLognormal | kSlotBit:
      return launch<kLognormal | kSlotBit | kLibBit>(args, s);
    case kEmpirical | kSlotBit:
      return launch<kEmpirical | kSlotBit | kLibBit>(args, s);
    case kExponential | kScenBit:
      return launch<kExponential | kScenBit | kLibBit>(args, s);
    case kWeibull | kScenBit:
      return launch<kWeibull | kScenBit | kLibBit>(args, s);
    case kBathtub | kScenBit:
      return launch<kBathtub | kScenBit | kLibBit>(args, s);
    case kLognormal | kScenBit:
      return launch<kLognormal | kScenBit | kLibBit>(args, s);
    case kEmpirical | kScenBit:
      return launch<kEmpirical | kScenBit | kLibBit>(args, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
