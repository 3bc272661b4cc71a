// A chunk of steps of the multi-job CTMC engine, fused into one kernel,
// hand-written for Hopper (sm_90a).
//
// Replaces, on the multi-job path, the Pallas TPU kernel
// src/repro/kernels/des_step.py::_event_race_kernel together with the
// lax.scan of src/repro/core/vectorized_multijob.py::_mj_chunk_loop that
// runs one _mj_step_u per step around it.  One launch runs n_steps steps of
// the port's plain step (repro_torch/core/vectorized_multijob.py::
// _mj_step_u) for every row of a (P * R,) batch of J-job clusters: the 16J
// rates (run * r_rand * computing, the systematic ones through the bad
// classes, the repair clocks' quotients) and the 2J residuals (each job's
// completion, then each job's overhead timer), the race of event_race.cuh,
// progress, timers, phases and completions, the per-job run-duration ring
// buffer, the failure counters and diagnosis, the proportional picks,
// shop entry against the repair servers and the queue lane, the
// replacement waterfall (own standbys, shared working pool, shared spare
// pool, stall), repair completions and escalation, the dispatcher (the
// longest-stalled job first), the standby refill or return to the origin
// pool, queue admission, the completion release with its J - 1 hand-offs,
// the streaming per-job histograms and the conservation check.
//
// Exactness.  Each operation is the plain step's, in its order, in
// float32: the same products (fail_sys = ((run * bad) * r_sys) *
// computing), the same correctly rounded quotients (the repair rates, the
// picks' cdf through ge_quot), logf in the race, the golden-ratio shift of
// the release picks rounded to float32 before the add and then torch.
// remainder's fmod.  The library is built with -fmad=false, so no a*b + c
// is contracted into an FMA that PyTorch's separate kernels never form.
// Pool counts are integer-valued floats, so their sums and cumsums are
// exact in any order.  The plain step writes a lane through torch.where
// and adds of masked zeros; the kernel writes only the lanes the step's
// event touches, which gives the same bits because no lane holds -0 (a
// masked +0 added to -0 would give +0).  A row whose jobs are all DONE
// is left as it is, as the plain step leaves it, and leaves its loop.
// Row b reads step k's uniforms at row b % R of the chunk's (n_steps,
// R_draw, 10) draw, which is what slicing the draw to R and tiling it over
// the P points gives the plain loop.
//
// What bounds it on an H100.  The bytes that must move are the uniforms
// (n_steps x R x 40 B) and each row's state read and written once (38 J +
// 15 words) and its parameter row read once (14 + J words), without the
// ring buffer and histograms, whose touched slots and bins count as the
// data needs them: for phase 20's grid (J = 3, 2,048 rows, 64 steps) about
// 2.9 MB, 0.9 us at 3.35 TB/s; its ~340 float32 operations a row-step are
// about 0.7 us at 67 TFLOP/s.  What sets the time is that each row's steps
// form one dependent chain of some thousands of instructions a step (the
// race over 16J lanes, the per-job loops, a few correctly rounded
// divisions), so a launch takes n_steps times one step's latency, whatever
// the row count up to the card's width.
//
// What the design does about that.  A thread serves a row, and the job
// count J is a template parameter (an instance for each J up to kMaxJobs),
// so every per-job loop unrolls and the race's 16J rates and 2J residuals
// live in registers (J = 1-3 fit in 144-248 registers; J >= 4 spill).  On
// an H100 a bounded loop over a runtime J, one instance for every J, ran a
// J = 3 launch 1.58x slower, its race lanes in local memory
// (scripts/torch_mj_chunk_variants.py, PERF.md).  The (J, 4) blocks run / sb / auto / man / q, the
// cached repair quotients, the per-job lanes and the per-job metrics are
// indexed by a runtime job (the failing, owning, receiving or released
// job), so they live in shared memory rather than as local arrays, a word
// a thread at a stride of the block's width (slot i of thread t at
// i * blockDim + t: a warp's threads read consecutive words, no bank
// conflicts).  The repair rates are kept divided, and only a class a step
// changes is divided again.  The pool picks are taken only where used,
// with the product test of ge_quot.  The next step's 40-byte uniform row
// is loaded into registers before this step's arithmetic (a cp.async copy
// into shared memory measured no faster).  The histogram
// edges are staged in shared memory once a launch; a row's bins are its
// thread's own, so a bin is a plain read-modify-write, no atomics.  The
// final state is written back in place (the wrapper passes clones unless
// the caller owns them).  Rows a block is a launch argument
// (kernels/mj_chunk.py's rows_per_block: 32, 64 or 128).  Blocks of 32
// rows spread phase 20's 2,048 rows over 64 SMs, a warp each; yet on an
// H100 blocks of 128 rows, four warps on each of 16 SMs, ran a launch
// 6-7% faster (PERF.md), so 128 is the default.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "event_race.cuh"

namespace {

// jobs a cluster the kernel takes (kernels/mj_chunk.py's MAX_JOBS)
constexpr int kMaxJobs = 8;
constexpr int kMaxThreads = 128;
constexpr int32_t kCompute = 0, kOverhead = 1, kStall = 2, kDone = 3;
// PyTorch casts a Python float scalar to the tensor's float32; these
// literals round to the same float32 values (1e-9 and 1e-30 both)
constexpr float kMinDiv = 1e-9f;
constexpr float kMinTotal = 1e-30f;
// the golden-ratio shift of the release picks, a double as in Python
constexpr double kPhi = 0.6180339887498949;
// uniforms a step: u_time, u_pick, u_diag, u_wrong, u_cls, u_esc, u_succ,
// u_pool, u_adm, u_rel
constexpr int kNU = 10;

// Histogram channel codes: the order of repro_torch.core.histograms.
// HIST_CHANNELS (the multi-job step carries the first three).
constexpr int kRunDuration = 0, kRecovery = 1, kWaiting = 2;

// Lane slots of MjChunkArgs, in the order of kernels/mj_chunk.py's
// BLOCKS, POOLS, JOB_LANES, JOB_METRICS and CLUSTER_METRICS.
enum Block { kRun, kSb, kAut, kMan, kQ, kNBlock };
enum Pool { kFw, kFs, kNPool };
enum JobLane { kWorkLeft, kTimer, kStallStart, kCurRun, kNJobLane };
enum JobMetric {
  kTotalTime, kUsefulWork, kNFailures, kNRandomFailures,
  kNSystematicFailures, kNUndiagnosed, kNMisdiagnosed, kNPreemptions,
  kNHostSelections, kNStandbySwaps, kStallTime, kRecoveryOverhead,
  kNJobMetric
};
enum ClusterMetric {
  kNAutoRepairs, kNManualRepairs, kNFailedRepairs, kStallHandoffs,
  kNShopQueued, kConservationErr, kNClusterMetric
};

}  // namespace

// Pointers and sizes of one launch; kernels/mj_chunk.py builds the same
// struct with ctypes.  Every lane is a contiguous CUDA tensor.
struct MjChunkArgs {
  float* block[kNBlock];                // (B, J, 4)
  float* pool[kNPool];                  // (B, 4) shared working, spare
  float* job_lane[kNJobLane];           // (B, J)
  float* job_metric[kNJobMetric];       // (B, J)
  float* cluster_metric[kNClusterMetric];  // (B,)
  float* t;                             // (B,)
  const float* fleet_total;             // (B,)
  int32_t* phase;                       // (B, J)
  int32_t* n_runs;                      // (B, J)
  float* run_durations;   // (B, J, max_runs); null when max_runs == 0
  float* hist;            // (B, J, n_sel, n_edges + 1); null without
  const float* hist_edges;  // (n_edges,)
  const float* pv;        // parameter rows: 14 columns, then J targets
  const float* us;        // (n_steps, R_draw, 10) uniforms
  int64_t pv_stride;      // 0: one row shared by the batch
  int64_t n_rows;         // B = P * R
  int64_t R;              // replicas a point: row b reads uniforms b % R
  int64_t R_draw;         // the draw's row count, >= R
  int32_t n_steps;
  int32_t max_runs;
  int32_t n_sel;          // histogram channels carried, 0..3
  int32_t n_edges;
  int32_t chan[3];        // their codes, in HIST_CHANNELS order
  int32_t n_jobs;         // J
  int32_t rows_per_block;
};

namespace {

__device__ __forceinline__ float f(bool b) { return b ? 1.0f : 0.0f; }

// torch.searchsorted(edges, v, right=True): the number of edges <= v, for
// nondecreasing edges (ctmc_chunk.cu's bin_index).  The log-spaced layout
// of HistogramSpec gives a guess g from log2(v); g is the answer exactly
// when edges[g-1] <= v < edges[g], which two reads check, and a binary
// search finds it otherwise.
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

// _pick_classes for one 4-class pool: a categorical draw proportional to
// counts, the count of u >= cumsum / total through ge_quot.
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

// torch.remainder(x, 1.0) on CUDA: fmod, then the divisor added where the
// signs differ (PyTorch's remainder kernel for floating types).
__device__ __forceinline__ float remainder1(float x) {
  float m = fmodf(x, 1.0f);
  if (m != 0.0f && ((1.0f < 0.0f) != (m < 0.0f))) m += 1.0f;
  return m;
}

// A thread's shared-memory words: word i at p[i * stride].
template <class T>
struct Slots {
  T* p;
  int stride;
  __device__ __forceinline__ T& operator[](int i) const {
    return p[i * stride];
  }
};

// The float words of a thread, for J jobs: the five (J, 4) blocks, the
// cached repair quotients of auto and man, the per-job lanes and metrics.
template <int J>
struct Layout {
  static constexpr int kBlock = 4 * J;
  static constexpr int kQAut = kNBlock * kBlock;
  static constexpr int kQMan = kQAut + kBlock;
  static constexpr int kLane = kQMan + kBlock;
  static constexpr int kMetric = kLane + kNJobLane * J;
  static constexpr int kFloats = kMetric + kNJobMetric * J;
  // then the int words: phase, n_runs
  static constexpr int kInts = 2 * J;
};

#ifdef MJ_RUNTIME_J
// The runtime-J instance (the library built with -DMJ_RUNTIME_J): the
// same words, their offsets computed from the launch's J.
struct LayoutRt {
  int kBlock, kQAut, kQMan, kLane, kMetric, kFloats, kInts;
  __device__ explicit LayoutRt(int J)
      : kBlock(4 * J), kQAut(kNBlock * 4 * J), kQMan(kQAut + 4 * J),
        kLane(kQMan + 4 * J), kMetric(kLane + kNJobLane * J),
        kFloats(kMetric + kNJobMetric * J), kInts(2 * J) {}
};
#define MJ_KERNEL_HEAD                                                   \
  __global__ void __launch_bounds__(kMaxThreads) mj_chunk_kernel_rt(     \
      const MjChunkArgs a, float* const rates_g, float* const words_g) { \
    const int J = a.n_jobs;                                              \
    const LayoutRt L(J);
#define MJ_L(x) L.x
#define MJ_NONE_STALLED !any_stalled_now
#define MJ_STALLED(j) (phase(j) == kStall && (j) != cj)
#else
#define MJ_KERNEL_HEAD                                                   \
  template <int J>                                                       \
  __global__ void __launch_bounds__(kMaxThreads)                         \
      mj_chunk_kernel(const MjChunkArgs a) {                             \
    using L = Layout<J>;
#define MJ_L(x) L::x
#define MJ_NONE_STALLED stalled_now == 0
#define MJ_STALLED(j) (stalled_now >> j) & 1u
#endif

MJ_KERNEL_HEAD
  extern __shared__ float smem[];
  const int n_pad = (a.n_edges + 3) & ~3;
  float* s_edges = smem;
  for (int i = threadIdx.x; i < a.n_edges; i += blockDim.x) {
    s_edges[i] = a.hist_edges[i];
  }
  __syncthreads();
  // the bin guess's scale (only a guess: bin_index checks it)
  const float lg0 = a.n_edges > 0 ? __log2f(s_edges[0]) : 0.0f;
  const float lg_span =
      a.n_edges > 1 ? __log2f(s_edges[a.n_edges - 1]) - lg0 : 0.0f;
  const float inv_step = a.n_edges > 1 ? (a.n_edges - 1) / lg_span : 0.0f;

  const int nt = static_cast<int>(blockDim.x);
  const int tid = static_cast<int>(threadIdx.x);
  const int64_t b = static_cast<int64_t>(blockIdx.x) * nt + tid;
  if (b >= a.n_rows) return;
#ifdef MJ_RUNTIME_J
  // the row's words in shared memory as the template's, or in global
  // memory (words_g: a row's words contiguous) where a block's rows do not
  // fit; its rates and residuals in global memory (rates_g), 18J a row
  const int w_stride = words_g != nullptr ? 1 : nt;
  float* const w_base = words_g != nullptr
                            ? words_g + b * (L.kFloats + L.kInts)
                            : smem + n_pad + tid;
  const Slots<float> s{w_base, w_stride};
  const Slots<int32_t> si{
      reinterpret_cast<int32_t*>(w_base + L.kFloats * w_stride), w_stride};
#else
  const Slots<float> s{smem + n_pad + tid, nt};
  const Slots<int32_t> si{
      reinterpret_cast<int32_t*>(smem + n_pad + MJ_L(kFloats) * nt) + tid, nt};
#endif

  // ---- the row's state ---------------------------------------------------
  bool live = false;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int32_t ph = a.phase[b * J + j];
    si[j] = ph;
    si[J + j] = a.n_runs[b * J + j];
    live = live || ph != kDone;
  }
  if (!live || a.n_steps == 0) return;   // inert: nothing changes

  // ---- parameters ------------------------------------------------------
  const float* p = a.pv + b * a.pv_stride;
  const float r_rand = p[0], r_sys = p[1], recovery = p[2], host_sel = p[3];
  const float waiting = p[4], auto_t = p[5], man_t = p[6];
  const float auto_fail = p[7], man_fail = p[8], p_auto = p[9];
  const float dp = p[10], du = p[11], preempt_cost = p[12], cap = p[13];
  const float* warm = p + 14;
  const float auto_div = fmaxf(auto_t, kMinDiv);
  const float man_div = fmaxf(man_t, kMinDiv);
  const float cap_eff = cap > 0.0f ? cap : INFINITY;
  const float rel_timer = recovery + host_sel;

#pragma unroll
  for (int k = 0; k < kNBlock; ++k) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float4 v =
          *reinterpret_cast<const float4*>(a.block[k] + (b * J + j) * 4);
      s[k * MJ_L(kBlock) + 4 * j] = v.x;
      s[k * MJ_L(kBlock) + 4 * j + 1] = v.y;
      s[k * MJ_L(kBlock) + 4 * j + 2] = v.z;
      s[k * MJ_L(kBlock) + 4 * j + 3] = v.w;
    }
  }
  // the repair rates aut / auto_div and man / man_div, kept divided: a
  // step changes at most a few classes, and only those are divided again
#pragma unroll
  for (int i = 0; i < MJ_L(kBlock); ++i) {
    s[MJ_L(kQAut) + i] = s[kAut * MJ_L(kBlock) + i] / auto_div;
    s[MJ_L(kQMan) + i] = s[kMan * MJ_L(kBlock) + i] / man_div;
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int k = 0; k < kNJobLane; ++k) {
      s[MJ_L(kLane) + k * J + j] = a.job_lane[k][b * J + j];
    }
#pragma unroll
    for (int m = 0; m < kNJobMetric; ++m) {
      s[MJ_L(kMetric) + m * J + j] = a.job_metric[m][b * J + j];
    }
  }
  float fw[4], fs[4];
  {
    const float4 w = *reinterpret_cast<const float4*>(a.pool[kFw] + 4 * b);
    const float4 x = *reinterpret_cast<const float4*>(a.pool[kFs] + 4 * b);
    fw[0] = w.x; fw[1] = w.y; fw[2] = w.z; fw[3] = w.w;
    fs[0] = x.x; fs[1] = x.y; fs[2] = x.z; fs[3] = x.w;
  }
  float t = a.t[b];
  const float fleet_total = a.fleet_total[b];
  float cm[kNClusterMetric];
#pragma unroll
  for (int i = 0; i < kNClusterMetric; ++i) cm[i] = a.cluster_metric[i][b];

  // accessors: block k of job j, class c; job lane k; job metric m
  auto blk = [&](int k, int j, int c) -> float& {
    return s[k * MJ_L(kBlock) + 4 * j + c];
  };
  auto qaut = [&](int j, int c) -> float& {
    return s[MJ_L(kQAut) + 4 * j + c];
  };
  auto qman = [&](int j, int c) -> float& {
    return s[MJ_L(kQMan) + 4 * j + c];
  };
  auto lane = [&](int k, int j) -> float& {
    return s[MJ_L(kLane) + k * J + j];
  };
  auto met = [&](int m, int j) -> float& {
    return s[MJ_L(kMetric) + m * J + j];
  };
  auto phase = [&](int j) -> int32_t& { return si[j]; };
  auto n_runs = [&](int j) -> int32_t& { return si[J + j]; };
  // a row's histogram bin for job j's channel `code`, if carried
  auto hist_add = [&](int j, int code, float v) {
    for (int c = 0; c < a.n_sel; ++c) {
      if (a.chan[c] != code) continue;
      const int idx = bin_index(s_edges, a.n_edges, v, lg0, inv_step);
      float* h = a.hist + ((b * J + j) * a.n_sel + c) * (a.n_edges + 1);
      h[idx] = h[idx] + 1.0f;
    }
  };

  // the next step's uniforms, loaded before this step's arithmetic: five
  // float2s of a 40-byte row
  const float2* ub = reinterpret_cast<const float2*>(a.us) + 5 * (b % a.R);
  const int64_t u_step = 5 * a.R_draw;             // float2s a step
  float2 n[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) n[i] = __ldg(ub + i);

  for (int k = 0; k < a.n_steps; ++k) {
    float u[kNU];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      u[2 * i] = n[i].x;
      u[2 * i + 1] = n[i].y;
    }
    if (k + 1 < a.n_steps) {
#pragma unroll
      for (int i = 0; i < 5; ++i) n[i] = __ldg(ub + (k + 1) * u_step + i);
    }
    const float u_time = u[0], u_pick = u[1], u_diag = u[2], u_wrong = u[3];
    const float u_cls = u[4], u_esc = u[5], u_succ = u[6], u_pool = u[7];
    const float u_adm = u[8], u_rel = u[9];

    // ---- rates (16J) and residuals (2J); the stalled jobs --------------
#ifdef MJ_RUNTIME_J
    float* const rates = rates_g + b * 18 * J;
    float* const resid = rates + 16 * J;
#else
    float rates[16 * J];
    float resid[2 * J];
#endif
    int k_star = 0;                 // argmin of the stall starts, first
    float k_star_start = INFINITY;
    bool any_stalled = false;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int32_t ph = phase(j);
      const bool comp = ph == kCompute;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float r = blk(kRun, j, c);
        const float bad = f(c % 2 == 1);
        rates[4 * j + c] = (r * r_rand) * f(comp);
        rates[4 * J + 4 * j + c] = ((r * bad) * r_sys) * f(comp);
        rates[8 * J + 4 * j + c] = qaut(j, c);
        rates[12 * J + 4 * j + c] = qman(j, c);
      }
      resid[j] = comp ? lane(kWorkLeft, j) : INFINITY;
      resid[J + j] = ph == kOverhead ? lane(kTimer, j) : INFINITY;
      if (ph == kStall) {
        any_stalled = true;
        const float ss = lane(kStallStart, j);
        if (ss < k_star_start) {
          k_star_start = ss;
          k_star = j;
        }
      }
    }
    float dt;
    int32_t ev;
    event_race_row(rates, 16 * J, nullptr, 0, resid, 2 * J, u_time, u_pick,
                   &dt, &ev);
    dt = isfinite(dt) ? dt : 0.0f;

    // the race's event: class, owning / failing job
    const int32_t cls = ev % 4;
    const int ej = (ev % (4 * J)) / 4;
    const bool is_fail = ev < 8 * J;
    const bool is_sys = ev >= 4 * J && ev < 8 * J;
    const bool is_auto = ev >= 8 * J && ev < 12 * J;
    const bool is_man = ev >= 12 * J && ev < 16 * J;
    const int cj = ev - 16 * J;         // the completing job, if in [0, J)
    const int tj = ev - 17 * J;         // the timer's job, if in [0, J)
    const bool owner_active = phase(ej) != kDone;
    const float t_new = t + dt;

    // ---- progress / completion / timers / run durations -----------------
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int32_t ph = phase(j);
      const float progress = ph == kCompute ? dt : 0.0f;
      if (ph == kCompute) {
        lane(kWorkLeft, j) = lane(kWorkLeft, j) - progress;
        met(kUsefulWork, j) = met(kUsefulWork, j) + progress;
      }
      if (ph == kOverhead) lane(kTimer, j) = lane(kTimer, j) - dt;
      if (j == tj) {
        phase(j) = kCompute;
        lane(kTimer, j) = INFINITY;
      }
      if (j == cj) {
        phase(j) = kDone;
        met(kTotalTime, j) = t_new;
      }
      const bool record = (is_fail && j == ej) || j == cj;
      const float run_val = lane(kCurRun, j) + progress;
      if (record) {
        if (a.max_runs > 0) {
          a.run_durations[(b * J + j) * a.max_runs
                          + n_runs(j) % a.max_runs] = run_val;
        }
        n_runs(j) += 1;
        hist_add(j, kRunDuration, run_val);
      }
      lane(kCurRun, j) = record ? 0.0f : run_val;
    }

    // ---- a failure ---------------------------------------------------------
    if (is_fail) {
      met(kNFailures, ej) = met(kNFailures, ej) + 1.0f;
      if (is_sys) {
        met(kNSystematicFailures, ej) = met(kNSystematicFailures, ej) + 1.0f;
      } else {
        met(kNRandomFailures, ej) = met(kNRandomFailures, ej) + 1.0f;
      }
      const bool diagnosed = u_diag < dp;
      const bool wrong = diagnosed && u_wrong < du;
      if (!diagnosed) met(kNUndiagnosed, ej) = met(kNUndiagnosed, ej) + 1.0f;
      if (wrong) met(kNMisdiagnosed, ej) = met(kNMisdiagnosed, ej) + 1.0f;
      bool use_sb = false, use_fw = false, use_fs = false;
      if (diagnosed) {
        float run_f[4], sb_f[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          run_f[c] = blk(kRun, ej, c);
          sb_f[c] = blk(kSb, ej, c);
        }
        // the misdiagnosis target within the failing job's running set
        const int rm = wrong ? pick_class(run_f, u_cls) : cls;
        blk(kRun, ej, rm) = blk(kRun, ej, rm) - 1.0f;
        // shop entry: a free service slot starts the automated stage; a
        // full shop parks the server in the queue lane (by owner)
        float shop_active = 0.0f;
#pragma unroll
        for (int i = 0; i < MJ_L(kBlock); ++i) {
          shop_active +=
              s[kAut * MJ_L(kBlock) + i] + s[kMan * MJ_L(kBlock) + i];
        }
        if (shop_active < cap_eff) {
          blk(kAut, ej, rm) = blk(kAut, ej, rm) + 1.0f;
          qaut(ej, rm) = blk(kAut, ej, rm) / auto_div;
        } else {
          blk(kQ, ej, rm) = blk(kQ, ej, rm) + 1.0f;
          cm[kNShopQueued] = cm[kNShopQueued] + 1.0f;
        }
        // replacement waterfall: own standbys -> shared working -> shared
        // spare -> stall
        use_sb = ((sb_f[0] + sb_f[1]) + sb_f[2]) + sb_f[3] > 0.0f;
        use_fw = !use_sb && ((fw[0] + fw[1]) + fw[2]) + fw[3] > 0.0f;
        use_fs = !use_sb && !use_fw
                 && ((fs[0] + fs[1]) + fs[2]) + fs[3] > 0.0f;
        if (use_sb || use_fw || use_fs) {
          float pool[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            pool[c] = use_sb ? sb_f[c] : (use_fw ? fw[c] : fs[c]);
          }
          const int pk = pick_class(pool, use_sb ? u_cls : u_pool);
          if (use_sb) {
            blk(kSb, ej, pk) = blk(kSb, ej, pk) - 1.0f;
            met(kNStandbySwaps, ej) = met(kNStandbySwaps, ej) + 1.0f;
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              fw[c] = use_fw && c == pk ? fw[c] - 1.0f : fw[c];
              fs[c] = use_fs && c == pk ? fs[c] - 1.0f : fs[c];
            }
            met(kNHostSelections, ej) = met(kNHostSelections, ej) + 1.0f;
            if (use_fs) met(kNPreemptions, ej) = met(kNPreemptions, ej) + 1.0f;
          }
          blk(kRun, ej, pk) = blk(kRun, ej, pk) + 1.0f;
        }
      }
      const bool goes_stall = diagnosed && !use_sb && !use_fw && !use_fs;
      const float fail_timer =
          (recovery + ((use_fw || use_fs) ? host_sel : 0.0f))
          + (use_fs ? waiting + preempt_cost : 0.0f);
      if (goes_stall) {
        phase(ej) = kStall;
        lane(kStallStart, ej) = t_new;
      } else {
        // resolved: its own recovery and waiting records
        phase(ej) = kOverhead;
        lane(kTimer, ej) = fail_timer;
        met(kRecoveryOverhead, ej) = met(kRecoveryOverhead, ej) + recovery;
        hist_add(ej, kRecovery, fail_timer);
        hist_add(ej, kWaiting, fail_timer - recovery);
      }
    }

    // ---- a repair completion -----------------------------------------------
    if (is_auto || is_man) {
      bool escalate = false;
      if (is_auto) {
        blk(kAut, ej, cls) = blk(kAut, ej, cls) - 1.0f;
        qaut(ej, cls) = blk(kAut, ej, cls) / auto_div;
        cm[kNAutoRepairs] = cm[kNAutoRepairs] + 1.0f;
        escalate = u_esc >= p_auto;
      } else {
        cm[kNManualRepairs] = cm[kNManualRepairs] + 1.0f;
      }
      if (escalate || is_man) {
        blk(kMan, ej, cls) = blk(kMan, ej, cls) + (escalate ? 1.0f : -1.0f);
        qman(ej, cls) = blk(kMan, ej, cls) / man_div;
      }
      const bool finishes = !escalate;
      if (finishes) {
        const float fail_prob = is_man ? man_fail : auto_fail;
        const bool healed = u_succ >= fail_prob;
        if (!healed) cm[kNFailedRepairs] = cm[kNFailedRepairs] + 1.0f;
        const int out_cls = healed ? cls - (cls % 2) : cls;
        // dispatcher: longest-stalled job anywhere > owner standby refill
        // > origin pool; the host-selection surcharge iff the receiver is
        // not the owner
        if (any_stalled) {
          const bool surcharge = k_star != ej;
          blk(kRun, k_star, out_cls) = blk(kRun, k_star, out_cls) + 1.0f;
          const float unstall_timer = recovery + (surcharge ? host_sel : 0.0f);
          phase(k_star) = kOverhead;
          lane(kTimer, k_star) = unstall_timer;
          const float stall_wait = t_new - k_star_start;
          met(kStallTime, k_star) = met(kStallTime, k_star) + stall_wait;
          if (surcharge) {
            met(kNHostSelections, k_star) =
                met(kNHostSelections, k_star) + 1.0f;
          }
          met(kRecoveryOverhead, k_star) =
              met(kRecoveryOverhead, k_star) + recovery;
          cm[kStallHandoffs] = cm[kStallHandoffs] + 1.0f;
          hist_add(k_star, kRecovery, stall_wait + unstall_timer);
          hist_add(k_star, kWaiting, (stall_wait + unstall_timer) - recovery);
        } else {
          const float sb_owner = ((blk(kSb, ej, 0) + blk(kSb, ej, 1))
                                  + blk(kSb, ej, 2)) + blk(kSb, ej, 3);
          if (owner_active && sb_owner < __ldg(warm + ej)) {
            blk(kSb, ej, out_cls) = blk(kSb, ej, out_cls) + 1.0f;
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              fw[c] = out_cls < 2 && c == out_cls ? fw[c] + 1.0f : fw[c];
              fs[c] = out_cls >= 2 && c == out_cls ? fs[c] + 1.0f : fs[c];
            }
          }
        }
        // a departure frees a service slot: admit one queued server,
        // proportionally over the queued (job, class) counts
        float q_tot = 0.0f;
#pragma unroll
        for (int i = 0; i < MJ_L(kBlock); ++i)
          q_tot += s[kQ * MJ_L(kBlock) + i];
        if (q_tot > 0.0f) {
          const float total = fmaxf(q_tot, kMinTotal);
          float cum = 0.0f;
          int pk = 0;
#pragma unroll
          for (int i = 0; i < MJ_L(kBlock); ++i) {
            cum += s[kQ * MJ_L(kBlock) + i];
            pk += ge_quot(u_adm, cum, total) ? 1 : 0;
          }
          pk = min(pk, MJ_L(kBlock) - 1);
          const int qj = pk / 4, qc = pk % 4;
          blk(kQ, qj, qc) = blk(kQ, qj, qc) - 1.0f;
          blk(kAut, qj, qc) = blk(kAut, qj, qc) + 1.0f;
          qaut(qj, qc) = blk(kAut, qj, qc) / auto_div;
        }
      }
    }

    // ---- a job completion: release its running + standby servers ----------
    if (cj >= 0 && cj < J) {
      float rel[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        rel[c] = blk(kRun, cj, c) + blk(kSb, cj, c);
        blk(kRun, cj, c) = 0.0f;
        blk(kSb, cj, c) = 0.0f;
      }
      // released servers go to starving jobs first, earliest stall first,
      // one each, with the host-selection surcharge
#ifdef MJ_RUNTIME_J
      // any J: a job is still to be served while its phase is STALL, which
      // the loop below ends for each job it serves (the bits of the
      // template's mask, read from the phases)
      bool any_stalled_now = false;
      for (int j = 0; j < J; ++j) {
        any_stalled_now = any_stalled_now || (phase(j) == kStall && j != cj);
      }
#else
      unsigned stalled_now = 0;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (phase(j) == kStall && j != cj) stalled_now |= 1u << j;
      }
#endif
#pragma unroll
      for (int r = 0; r < J - 1; ++r) {
        const float rel_tot = ((rel[0] + rel[1]) + rel[2]) + rel[3];
        if (MJ_NONE_STALLED || !(rel_tot > 0.0f)) break;
        int k_r = 0;
        float best = INFINITY;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float ss = MJ_STALLED(j) ? lane(kStallStart, j)
                                                   : INFINITY;
          if (ss < best) {
            best = ss;
            k_r = j;
          }
        }
        // the shift rounds to float32 before the add, as the plain step's
        // Python float does
        const float u_r = remainder1(
            u_rel + static_cast<float>(static_cast<double>(r) * kPhi));
        const int pk = pick_class(rel, u_r);
#pragma unroll
        for (int c = 0; c < 4; ++c) rel[c] = c == pk ? rel[c] - 1.0f : rel[c];
        blk(kRun, k_r, pk) = blk(kRun, k_r, pk) + 1.0f;
        const float rel_wait = t_new - lane(kStallStart, k_r);
        phase(k_r) = kOverhead;
        lane(kTimer, k_r) = rel_timer;
        met(kStallTime, k_r) = met(kStallTime, k_r) + rel_wait;
        met(kNHostSelections, k_r) = met(kNHostSelections, k_r) + 1.0f;
        met(kRecoveryOverhead, k_r) = met(kRecoveryOverhead, k_r) + recovery;
        hist_add(k_r, kRecovery, rel_wait + rel_timer);
        hist_add(k_r, kWaiting, (rel_wait + rel_timer) - recovery);
#ifdef MJ_RUNTIME_J
        any_stalled_now = false;
        for (int j = 0; j < J; ++j) {
          any_stalled_now = any_stalled_now
                            || (phase(j) == kStall && j != cj);
        }
#else
        stalled_now &= ~(1u << k_r);
#endif
      }
      // the remainder lands in the origin pools
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        fw[c] = fw[c] + (c >= 2 ? 0.0f : rel[c]);
        fs[c] = fs[c] + (c >= 2 ? rel[c] : 0.0f);
      }
    }

    // ---- conservation invariant ----------------------------------------
    float tot = 0.0f;
#pragma unroll
    for (int i = 0; i < kNBlock * MJ_L(kBlock); ++i) tot += s[i];
    tot += (((fw[0] + fw[1]) + fw[2]) + fw[3])
           + (((fs[0] + fs[1]) + fs[2]) + fs[3]);
    cm[kConservationErr] = fmaxf(cm[kConservationErr],
                                 fabsf(tot - fleet_total));

    t = t_new;
    // a row whose jobs are all DONE stays as it is for the rest of the chunk
    bool any_live = false;
#pragma unroll
    for (int j = 0; j < J; ++j) any_live = any_live || phase(j) != kDone;
    if (!any_live) break;
  }

  // ---- write back ---------------------------------------------------------
#pragma unroll
  for (int k = 0; k < kNBlock; ++k) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      *reinterpret_cast<float4*>(a.block[k] + (b * J + j) * 4) =
          make_float4(blk(k, j, 0), blk(k, j, 1), blk(k, j, 2),
                      blk(k, j, 3));
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int k = 0; k < kNJobLane; ++k) a.job_lane[k][b * J + j] = lane(k, j);
#pragma unroll
    for (int m = 0; m < kNJobMetric; ++m) {
      a.job_metric[m][b * J + j] = met(m, j);
    }
    a.phase[b * J + j] = phase(j);
    a.n_runs[b * J + j] = n_runs(j);
  }
  *reinterpret_cast<float4*>(a.pool[kFw] + 4 * b) =
      make_float4(fw[0], fw[1], fw[2], fw[3]);
  *reinterpret_cast<float4*>(a.pool[kFs] + 4 * b) =
      make_float4(fs[0], fs[1], fs[2], fs[3]);
  a.t[b] = t;
#pragma unroll
  for (int i = 0; i < kNClusterMetric; ++i) a.cluster_metric[i][b] = cm[i];
}

}  // namespace

// Dynamic shared memory of a launch: the bin edges padded to 16 bytes,
// then each thread's words.
static size_t smem_bytes(const MjChunkArgs* args, int floats, int ints) {
  return (static_cast<size_t>((args->n_edges + 3) & ~3)
          + static_cast<size_t>(floats + ints) * args->rows_per_block)
         * sizeof(float);
}

#ifdef MJ_RUNTIME_J
// Plain-C entry point of the runtime-J instance, for ctypes: any J >= 1.
// `rates` is the launch's (B, 18 J) float scratch for each row's rates
// and residuals; `words` is null for a row's words in shared memory (then
// rows_per_block rows must fit a block) or a (B, 46 J) float scratch for
// them in global memory.  Returns as mj_chunk_launch.
extern "C" int mj_chunk_rt_launch(const MjChunkArgs* args, float* rates,
                                  float* words, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = args->rows_per_block;
  const int J = args->n_jobs;
  if (rows < 32 || rows > kMaxThreads || rows % 32 != 0
      || args->n_sel < 0 || args->n_sel > 3 || J < 1 || rates == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int floats = words != nullptr ? 0 : 44 * J;
  const int ints = words != nullptr ? 0 : 2 * J;
  const size_t smem = smem_bytes(args, floats, ints);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mj_chunk_kernel_rt, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (args->n_rows + rows - 1) / rows;
  mj_chunk_kernel_rt<<<static_cast<unsigned int>(blocks), rows, smem, s>>>(
      *args, rates, words);
  return static_cast<int>(cudaGetLastError());
}
#else
template <int J>
static int launch(const MjChunkArgs* args, cudaStream_t stream) {
  using L = Layout<J>;
  const size_t smem = smem_bytes(args, L::kFloats, L::kInts);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mj_chunk_kernel<J>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int rows = args->rows_per_block;
  const int64_t blocks = (args->n_rows + rows - 1) / rows;
  mj_chunk_kernel<J>
      <<<static_cast<unsigned int>(blocks), rows, smem, stream>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// Plain-C entry point for ctypes.  `args` points to the launch's struct in
// host memory; `stream` is a cudaStream_t passed as an integer.  Returns
// the first CUDA error of the shared-memory attribute or the launch (0 on
// success), or cudaErrorInvalidValue for a job count above kMaxJobs or a
// block width the kernel does not take; the caller raises on anything
// else.
extern "C" int mj_chunk_launch(const MjChunkArgs* args, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = args->rows_per_block;
  if (rows < 32 || rows > kMaxThreads || rows % 32 != 0
      || args->n_sel < 0 || args->n_sel > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (args->n_jobs) {
    case 1: return launch<1>(args, s);
    case 2: return launch<2>(args, s);
    case 3: return launch<3>(args, s);
    case 4: return launch<4>(args, s);
    case 5: return launch<5>(args, s);
    case 6: return launch<6>(args, s);
    case 7: return launch<7>(args, s);
    case 8: return launch<8>(args, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif
