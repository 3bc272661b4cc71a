"""The paper's capacity-planning case study (§IV), end to end, on the
PyTorch/CUDA port.

Question: how many servers beyond the 4096-server job minimum should the
working pool hold?  Too few -> preemptions and stalls; too many -> wasted
energy and capacity.

The same studies as ``examples/capacity_planning.py``, through
``repro_torch``.  Runs a OneWaySweep over working-pool sizes through the
engine-dispatch layer (``engine="ctmc"`` -> the vectorized batched path)
at the exact Table-I parameters, cross-checks the analytic spare-capacity
bound, and prints a recommendation.  Pool size is a *structural* knob:
thanks to structure padding the whole grid still runs as one batch (one
chunk-kernel launch per 64 steps on the card), and the exact per-run
records give the mean time between restarts (the ETTF-style metric
operators tune on) per pool size.

``--hazard bathtub`` (the default) additionally re-runs the sweep under
an age-dependent bathtub failure process on ``engine="auto"`` — which
takes the vectorized fast path too (docs/distributions.md), so the
what-if is another single batch.  Infant mortality raises the effective failure rate
(restart-reset clocks live near the left edge of the hazard curve), so
the capacity answer genuinely shifts — that comparison is the point.

``--repairs lognormal`` (the default) adds a repair-policy what-if on
the fast path as well: heavy-tailed (lognormal, sigma=1.2) repair times
at the same means, swept over ``auto_repair_time`` — the ETTR
percentile table, one batch through the repair-slot lane.

CTMC studies run on ``--device`` (default: the card).  The multi-job
what-if runs its whole grid through the multi-job CTMC engine, one launch
of the multi-job chunk kernel every 64 steps on the card.

    PYTHONPATH=src python examples/torch_capacity_planning.py [--fast] \
        [--device cpu]
"""

import argparse

from repro_torch.core import (MINUTES_PER_DAY, OneWaySweep, Params,
                              repair_shop_occupancy, spare_capacity_bound)

parser = argparse.ArgumentParser()
parser.add_argument("--fast", action="store_true", help="fewer replicas")
parser.add_argument("--job-days", type=float, default=32.0)
parser.add_argument("--engine", choices=("auto", "event", "ctmc"),
                    default="ctmc")
parser.add_argument("--hazard", choices=("exponential", "bathtub"),
                    default="bathtub",
                    help="hazard family for the what-if section")
parser.add_argument("--repairs", choices=("exponential", "lognormal"),
                    default="lognormal",
                    help="repair family for the repair-policy what-if")
parser.add_argument("--shock", choices=("off", "on"), default="on",
                    help="correlated-failure what-if: rack-shock-rate "
                         "sweep under a 40-rack topology")
parser.add_argument("--jobs", choices=("off", "on"), default="on",
                    help="multi-job what-if: spare-pool x repair-server "
                         "grid with three mixed-size jobs sharing one "
                         "pool and one repair shop")
parser.add_argument("--tune", choices=("off", "on"), default="on",
                    help="checkpoint what-if: goodput-optimal checkpoint "
                         "interval via golden-section on the fast path, "
                         "cross-checked against Young/Daly")
parser.add_argument("--device", default=None,
                    help="device of the CTMC engine (default: the card)")
args = parser.parse_args()

N_REP = 64 if args.fast else 256
POOLS = [4112, 4128, 4160, 4192, 4256]

base = Params(job_length=args.job_days * MINUTES_PER_DAY)

print(f"analytic repair-shop occupancy : "
      f"{repair_shop_occupancy(base):6.1f} servers (Little's law)")
print(f"analytic 99% spare bound       : "
      f"{spare_capacity_bound(base):6.1f} servers above the job\n")

sweep = OneWaySweep("capacity", "working_pool_size", POOLS,
                    n_replications=N_REP, base_params=base,
                    engine=args.engine, device=args.device)
rows = []
for point in sweep.run().points:
    pool = point.values["working_pool_size"]
    ettf, ettr = point.stats["run_duration_dist"], point.stats["recovery_dist"]
    rows.append({
        "pool": pool,
        "extra": pool - base.job_size - base.warm_standbys,
        "hours": point.stats["total_time"].mean / 60,
        "ci": point.stats["total_time"].ci95_halfwidth(N_REP) / 60,
        "stall_h": point.stats["stall_time"].mean / 60,
        "preempt": point.stats["n_preemptions"].mean,
        # exact pooled run durations (time between restarts), not the
        # old total_time/(n_failures+1) approximation
        "ettf_h": point.stats["run_duration_pooled"].mean / 60,
        # streaming-histogram percentiles: the distribution tails that
        # drive checkpoint cadence and spare capacity (exact to one bin
        # width, unbounded run count — no ring-buffer truncation)
        "ettf_p50": ettf.percentiles[50] / 60,
        "ettf_p99": ettf.percentiles[99] / 60,
        "ettr_p50": ettr.percentiles[50],
        "ettr_p99": ettr.percentiles[99],
    })

print(f"{'pool':>6} {'extra':>6} {'train hours':>14} {'stall h':>9} "
      f"{'preempts':>9} {'ettf h':>8}")
for r in rows:
    print(f"{r['pool']:>6} {r['extra']:>6} {r['hours']:>9.1f} +-{r['ci']:<4.1f}"
          f" {r['stall_h']:>9.2f} {r['preempt']:>9.2f} {r['ettf_h']:>8.2f}")

print("\ndistribution percentiles (streaming histograms; h = hours, "
      "min = minutes):")
print(f"{'pool':>6} {'ettf p50 h':>11} {'ettf p99 h':>11} "
      f"{'ettr p50 min':>13} {'ettr p99 min':>13}")
for r in rows:
    print(f"{r['pool']:>6} {r['ettf_p50']:>11.2f} {r['ettf_p99']:>11.2f} "
          f"{r['ettr_p50']:>13.1f} {r['ettr_p99']:>13.1f}")

# recommendation: the smallest pool within 0.5% of the best time
best = min(r["hours"] for r in rows)
for r in rows:
    if r["hours"] <= best * 1.005:
        print(f"\nRECOMMENDATION: working pool {r['pool']} "
              f"(+{r['pool'] - 4096} over the job size) — larger pools buy "
              f"<0.5% — matching the paper's finding that ~+32 extra "
              f"servers over job+standbys suffice at these rates.")
        break

# ---------------------------------------------------------------------------
# what-if: age-dependent (bathtub) failures, engine="auto" fast path
# ---------------------------------------------------------------------------
if args.hazard == "bathtub":
    bathtub = base.replace(
        job_length=min(args.job_days, 8.0) * MINUTES_PER_DAY,
        failure_distribution="bathtub",
        distribution_kwargs={"infant_factor": 5.0,
                             "infant_tau": 7 * MINUTES_PER_DAY})
    n_rep_bt = max(N_REP // 4, 32)
    print(f"\n=== what-if: bathtub hazard (infant x5, tau 7d), "
          f"engine=auto, {n_rep_bt} reps ===")
    bt_rows = []
    for point in OneWaySweep("capacity-bathtub", "working_pool_size", POOLS,
                             n_replications=n_rep_bt, base_params=bathtub,
                             engine="auto", device=args.device).run().points:
        ettr = point.stats["recovery_dist"]
        bt_rows.append({
            "pool": point.values["working_pool_size"],
            "engine": point.engine,     # "ctmc": the fast path took it
            "hours": point.stats["total_time"].mean / 60,
            "fails": point.stats["n_failures"].mean,
            "stall_h": point.stats["stall_time"].mean / 60,
            "ettr_p99": ettr.percentiles[99],
            # cross-replica spread of each replica's own p99 ETTR — the
            # run-to-run variability a pooled histogram cannot show
            "ettr_p99_iqr": point.stats["recovery_p99_replica"].iqr,
        })
    print(f"{'pool':>6} {'engine':>7} {'train h':>9} {'fails':>8} "
          f"{'stall h':>8} {'ettr p99':>9} {'p99 iqr':>8}")
    for r in bt_rows:
        print(f"{r['pool']:>6} {r['engine']:>7} {r['hours']:>9.1f} "
              f"{r['fails']:>8.1f} {r['stall_h']:>8.2f} "
              f"{r['ettr_p99']:>9.1f} {r['ettr_p99_iqr']:>8.2f}")
    assert all(r["engine"] == "ctmc" for r in bt_rows), \
        "bathtub grid should ride the vectorized fast path via auto"
    print("\nInfant mortality multiplies the effective failure rate "
          "(restart-reset clocks stay near age zero), so spare capacity "
          "that was comfortable under the exponential model tightens — "
          "compare the stall columns above.")

# ---------------------------------------------------------------------------
# what-if: heavy-tailed repairs (repair-policy grid on the fast path)
# ---------------------------------------------------------------------------
if args.repairs == "lognormal":
    heavy = base.replace(
        job_length=min(args.job_days, 8.0) * MINUTES_PER_DAY,
        repair_distribution="lognormal",
        distribution_kwargs={"sigma": 1.2})
    n_rep_rp = max(N_REP // 4, 32)
    auto_times = [60.0, 120.0, 240.0]
    print(f"\n=== what-if: lognormal repairs (sigma 1.2, same means), "
          f"auto_repair_time sweep, engine=auto, {n_rep_rp} reps ===")
    rp_rows = []
    for point in OneWaySweep("repair-policy", "auto_repair_time", auto_times,
                             n_replications=n_rep_rp, base_params=heavy,
                             engine="auto", device=args.device).run().points:
        ettr = point.stats["recovery_dist"]
        rp_rows.append({
            "auto_min": point.values["auto_repair_time"],
            "engine": point.engine,     # "ctmc": the repair-slot lane
            "hours": point.stats["total_time"].mean / 60,
            "stall_h": point.stats["stall_time"].mean / 60,
            # ETTR distribution tails under heavy-tailed repair times —
            # the table that used to require the event engine
            "ettr_p50": ettr.percentiles[50],
            "ettr_p99": ettr.percentiles[99],
        })
    print(f"{'auto min':>9} {'engine':>7} {'train h':>9} {'stall h':>8} "
          f"{'ettr p50':>9} {'ettr p99':>9}")
    for r in rp_rows:
        print(f"{r['auto_min']:>9.0f} {r['engine']:>7} {r['hours']:>9.1f} "
              f"{r['stall_h']:>8.2f} {r['ettr_p50']:>9.1f} "
              f"{r['ettr_p99']:>9.1f}")
    assert all(r["engine"] == "ctmc" for r in rp_rows), \
        "repair-policy grid should ride the repair-slot lane via auto"
    print("\nHeavy-tailed repairs at the same mean stretch the ETTR tail "
          "(compare p99 against the mean-matched exponential model) — "
          "the spare-capacity margin has to cover the tail, not the "
          "mean, which is exactly what the percentile columns price in.")

# ---------------------------------------------------------------------------
# what-if: correlated failure domains (docs/scenarios.md)
# ---------------------------------------------------------------------------
if args.shock == "on":
    from repro_torch.core import FaultTopology

    # 4360-server fleet / 40 racks = 109 per rack, exact striping; the
    # shock rates are parameter columns, so the whole grid is one batch
    shocked = base.replace(
        job_length=min(args.job_days, 8.0) * MINUTES_PER_DAY,
        fault_domains=FaultTopology(n_racks=40, racks_per_pod=8))
    n_rep_sh = max(N_REP // 4, 32)
    rates = [0.0, 2e-6, 5e-6, 1e-5]
    print(f"\n=== what-if: correlated rack outages (40 racks, whole-rack "
          f"shocks), rack_shock_rate sweep, engine=auto, {n_rep_sh} reps "
          f"===")
    sh_rows = []
    for point in OneWaySweep("capacity-shock", "rack_shock_rate", rates,
                             n_replications=n_rep_sh, base_params=shocked,
                             engine="auto", device=args.device).run().points:
        sh_rows.append({
            "rate": point.values["rack_shock_rate"],
            "engine": point.engine,     # "ctmc": scenario fast path
            "hours": point.stats["total_time"].mean / 60,
            "shocks": point.stats["n_domain_shocks"].mean,
            "killed": point.stats["n_shock_killed"].mean,
            "stall_h": point.stats["stall_time"].mean / 60,
            "preempt": point.stats["n_preemptions"].mean,
        })
    print(f"{'rate/min':>9} {'engine':>7} {'train h':>9} {'shocks':>7} "
          f"{'killed':>7} {'stall h':>8} {'preempts':>9}")
    for r in sh_rows:
        print(f"{r['rate']:>9.0e} {r['engine']:>7} {r['hours']:>9.1f} "
              f"{r['shocks']:>7.2f} {r['killed']:>7.1f} "
              f"{r['stall_h']:>8.2f} {r['preempt']:>9.2f}")
    assert all(r["engine"] == "ctmc" for r in sh_rows), \
        "shock grid should ride the scenario fast path via auto"
    base_h = sh_rows[0]["hours"]
    worst = sh_rows[-1]
    print(f"\nA whole-rack outage kills 109 servers at once — the job, "
          f"its standbys, and its spares lose their rack stripe "
          f"together.  At {worst['rate']:.0e}/min per rack the shocks "
          f"cost {worst['hours'] - base_h:+.1f} train hours vs the "
          f"uncorrelated baseline; spare capacity sized for i.i.d. "
          f"failures underestimates the burst draw (compare the "
          f"preemption column).  Scripted campaigns (exact kill times, "
          f"maintenance windows) cover the deterministic side — see "
          f"docs/scenarios.md.")

# ---------------------------------------------------------------------------
# what-if: multi-job shared-pool contention (docs/multijob.md)
# ---------------------------------------------------------------------------
if args.jobs == "on":
    from repro_torch.core import JobSpec, MultiJobSweep
    from repro_torch.kernels import ctmc_chunk, des_step, mj_chunk

    # three mixed-size jobs on one 200-server pool: how many spares and
    # repair servers does the *fleet* need?  Job count is the only
    # structure key, so the whole 3x2 grid (mixed sizes included) is one
    # batch: on the card, one launch of the multi-job chunk kernel every
    # 64 steps.
    mj_cluster = Params(
        working_pool_size=200, spare_pool_size=12, job_size=64,
        job_length=720.0, random_failure_rate=0.004,
        systematic_failure_rate=0.01, auto_repair_time=180.0,
        manual_repair_time=480.0, repair_servers=4, histogram=None)
    mj_jobs = [JobSpec(64, 720.0, warm_standbys=2),
               JobSpec(32, 1000.0, warm_standbys=1),
               JobSpec(16, 860.0, warm_standbys=1)]
    n_rep_mj = max(N_REP // 4, 32)
    print(f"\n=== what-if: 3 mixed-size jobs (64/32/16) on one shared "
          f"pool, spare x repair-server grid, engine=auto, {n_rep_mj} "
          f"reps ===")
    race_before, chunk_before = des_step.LAUNCHES, ctmc_chunk.LAUNCHES
    mj_before = mj_chunk.LAUNCHES
    mj = MultiJobSweep("fleet-capacity", mj_jobs, "spare_pool_size",
                       [8, 10, 12], parameter_b="repair_servers",
                       values_b=[3, 4], n_replications=n_rep_mj,
                       base_params=mj_cluster, engine="auto",
                       device=args.device).run()
    race = des_step.LAUNCHES - race_before
    chunks = ctmc_chunk.LAUNCHES - chunk_before
    mj_launches = mj_chunk.LAUNCHES - mj_before
    print(f"{'spares':>7} {'shop':>5} {'engine':>7} {'makespan h':>11} "
          f"{'stalls':>7} {'queued':>7} {'job0 h':>7} {'job2 h':>7}")
    for p in mj.points:
        print(f"{p.values['spare_pool_size']:>7} "
              f"{p.values['repair_servers']:>5} {p.engine:>7} "
              f"{p.stats['makespan'].mean / 60:>11.1f} "
              f"{p.stats['stall_handoffs'].mean:>7.1f} "
              f"{p.stats['n_shop_queued'].mean:>7.1f} "
              f"{p.stats['job0_total_time'].mean / 60:>7.1f} "
              f"{p.stats['job2_total_time'].mean / 60:>7.1f}")
    assert all(p.engine == "ctmc" for p in mj.points), \
        "multi-job grid should ride the compartment engine via auto"
    on_card = args.device is None or str(args.device).startswith("cuda")
    print(f"\nmulti-job chunk-kernel launches {mj_launches}, event-race "
          f"kernel launches {race}, chunk-kernel launches {chunks}")
    # on the card every chunk of the grid is one multi-job chunk launch, the
    # standalone race never launches and no 1-job point takes the
    # single-job chunk kernel; on the CPU nothing launches
    assert race == chunks == 0 and (mj_launches > 0 if on_card
                                    else mj_launches == 0), \
        (f"multi-job grid: {mj_launches} multi-job chunk, {race} race and "
         f"{chunks} chunk launches")
    print("\nThe fleet view prices what single-job sweeps cannot: spares "
          "and repair servers are shared, so the small job's stalls are "
          "set by the big job's failure traffic.  Watch the queued "
          "column — a shop one server short backs up every job at once "
          "(hand-offs go FIFO to the longest-stalled job; see "
          "docs/multijob.md).")

# ---------------------------------------------------------------------------
# what-if: goodput-optimal checkpoint cadence (docs/optimization.md)
# ---------------------------------------------------------------------------
if args.tune == "on":
    from repro_torch.core import cluster_failure_rate, young_daly_interval
    from repro_torch.core.optimize import optimize_checkpoint_interval

    # every interval candidate is a column of the parameter row, so each
    # search round (coarse grid, every golden-section iteration) is one
    # batch; a one-minute write: at this fleet's ~20-min MTBF a long write
    # would drown the job in overhead — the knob only has an interior
    # optimum when C << MTBF, the regime the +-4x bracket stays inside
    tuned = base.replace(
        job_length=min(args.job_days, 8.0) * MINUTES_PER_DAY,
        checkpoint_cost=1.0)
    n_rep_ck = max(N_REP // 4, 32)
    mtbf = 1.0 / cluster_failure_rate(tuned)
    yd = young_daly_interval(tuned.checkpoint_cost, mtbf)
    print(f"\n=== what-if: checkpoint cadence (write cost "
          f"{tuned.checkpoint_cost:.0f} min, fleet MTBF {mtbf:.0f} min), "
          f"golden-section on goodput, {n_rep_ck} reps ===")
    res = optimize_checkpoint_interval(tuned, n_replicas=n_rep_ck,
                                       bounds=(yd / 4.0, yd * 4.0),
                                       n_grid=8, refine_iters=6,
                                       device=args.device)
    print(f"{'interval min':>13} {'goodput':>9}")
    for iv, g in zip(res.grid, res.grid_objective):
        mark = " <- grid argmax" if g == max(res.grid_objective) else ""
        print(f"{iv:>13.1f} {g:>9.4f}{mark}")
    print(f"\nYoung/Daly sqrt(2*C*MTBF)      : {res.young_daly:8.1f} min")
    print(f"simulated goodput optimum      : {res.interval:8.1f} min "
          f"(goodput {res.objective:.4f}, {res.n_evals} candidates, "
          f"{len(res.history)} refinement iterations)")
    print("\nThe first-order Young/Daly cadence and the simulated optimum "
          "agree to about a grid notch here — the analytical cross-check "
          "that pins the optimizer (tests/test_checkpoint_opt.py).  The "
          "simulated curve additionally prices what the formula ignores: "
          "stalls, pool depletion, and host-selection overhead all load "
          "the denominator of goodput = useful work / wall clock.")
