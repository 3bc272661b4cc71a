"""Run parity of the port's multi-job CTMC engine against the port's event
engine.

The event engine is the oracle (bit-identical to the reference's).  On
tests/test_multijob_parity.py's two- and four-job clusters: per-job and
fleet means of the pinned metrics within |z| < 3.5, per-job histogram
channels' means within |z| < 3.5 and their percentiles within one bin,
every replica's servers conserved.  A cluster that never contends
factorizes into independent single-job runs.  Seeds are fixed, so every
run checks the same cases.
"""

import math

import numpy as np
import torch

from repro_torch.core import backend as tb
from repro_torch.core import metrics as tmet
from repro_torch.core import vectorized as tv
from repro_torch.core import vectorized_multijob as tm
from repro_torch.core.multijob import JobSpec, simulate_multijob
from repro_torch.core.params import Params

torch.set_num_threads(1)

Z_MAX = 3.5

#: tests/test_multijob_parity.py's clusters and pinned metrics
TWO_JOB_CLUSTER = Params(
    working_pool_size=110, spare_pool_size=16, job_size=16,
    job_length=4000.0, random_failure_rate=0.001,
    systematic_failure_rate=0.005, auto_repair_time=180.0,
    manual_repair_time=480.0, repair_servers=6)
TWO_JOBS = (JobSpec(32, 4000.0, warm_standbys=2),
            JobSpec(16, 6000.0, warm_standbys=1))
FOUR_JOB_CLUSTER = Params(
    working_pool_size=110, spare_pool_size=12, job_size=16,
    job_length=3000.0, random_failure_rate=0.001,
    systematic_failure_rate=0.005, auto_repair_time=150.0,
    manual_repair_time=420.0, repair_servers=5)
FOUR_JOBS = (JobSpec(24, 3000.0, warm_standbys=2),
             JobSpec(16, 4000.0, warm_standbys=1),
             JobSpec(12, 3500.0, warm_standbys=1),
             JobSpec(8, 5000.0, warm_standbys=1))
_PINNED_JOB_METRICS = ("total_time", "n_failures", "stall_time",
                       "n_preemptions", "recovery_overhead")
_PINNED_FLEET_METRICS = ("makespan", "stall_handoffs", "n_auto_repairs",
                         "n_manual_repairs", "n_shop_queued")


def _z(a, b):
    a = np.asarray(a, float)
    b = np.asarray(b, float)
    se = math.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
    return (a.mean() - b.mean()) / max(se, 1e-12)


def _z_hist(ha, hb):
    na, nb = ha.total, hb.total
    if na < 2 or nb < 2:
        return 0.0
    se = math.sqrt(ha.std() ** 2 / na + hb.std() ** 2 / nb)
    return (ha.mean() - hb.mean()) / max(se, 1e-12)


def _cdf_at(h, value):
    idx = int(np.searchsorted(np.asarray(h.edges, float), value,
                              side="right"))
    cum = np.cumsum(np.asarray(h.counts, float))
    below = cum[idx - 1] if idx > 0 else 0.0
    return below / max(h.total, 1)


def _assert_one_bin(ha, hb, what, qs=(50, 90)):
    """Percentiles within one bin, or the other engine's CDF within 0.05
    at the percentile (bimodal channels put percentiles on knife edges),
    as tests/test_multijob_parity.py holds them."""
    edges = np.asarray(ha.edges, float)
    for q in qs:
        va, vb = ha.percentile(q), hb.percentile(q)
        ia = int(np.searchsorted(edges, va, side="right"))
        ib = int(np.searchsorted(edges, vb, side="right"))
        cdf_gap = abs(_cdf_at(hb, va) - q / 100.0)
        assert abs(ia - ib) <= 1 or cdf_gap <= 0.05, (
            f"{what} p{q}: bins {ia} vs {ib} ({va:.3f} vs {vb:.3f}), "
            f"cdf gap {cdf_gap:.3f}")


def _parity_case(cluster, jobs, n_ctmc, n_event, seed):
    assert tb.resolve_engine_multijob(cluster, jobs) == "ctmc"
    point = tm.simulate_multijob_ctmc_sweep([(cluster, jobs)],
                                            n_replicas=n_ctmc, seed=seed,
                                            device="cpu")[0]
    agg = tmet.aggregate_multijob_arrays(point)
    results = simulate_multijob(cluster, list(jobs),
                                n_replications=n_event, base_seed=seed + 1)

    # the contention machinery is exercised on both sides
    assert float(np.mean(point["n_shop_queued"])) > 0
    assert np.mean([r.queue_events for r in results]) > 0
    assert float(np.max(point["conservation_err"])) == 0.0
    assert float(point["completed"].min()) == 1.0

    spec = cluster.histogram
    for j in range(len(jobs)):
        cj = point["per_job"][j]
        for metric in _PINNED_JOB_METRICS:
            ev = [float(getattr(r.per_job[j], metric)) for r in results]
            z = _z(cj[metric], ev)
            assert abs(z) < Z_MAX, f"job{j} {metric}: z={z:+.2f}"
        ct_hists = agg["per_job_histograms"][j]
        ev_hists = tmet.pool_histograms(
            [r.per_job_histograms(spec)[j] for r in results])
        for ch in ("run_duration", "recovery", "waiting"):
            z = _z_hist(ct_hists[ch], ev_hists[ch])
            assert abs(z) < Z_MAX, f"job{j} {ch} mean: z={z:+.2f}"
            _assert_one_bin(ct_hists[ch], ev_hists[ch], f"job{j} {ch}")

    fleet_event = {
        "makespan": [r.makespan for r in results],
        "stall_handoffs": [float(r.stall_events) for r in results],
        "n_auto_repairs": [float(r.cluster.n_auto_repairs)
                           for r in results],
        "n_manual_repairs": [float(r.cluster.n_manual_repairs)
                             for r in results],
        "n_shop_queued": [float(r.queue_events) for r in results],
    }
    for metric in _PINNED_FLEET_METRICS:
        z = _z(point[metric], fleet_event[metric])
        assert abs(z) < Z_MAX, f"fleet {metric}: z={z:+.2f}"


def test_two_job_contention_parity():
    _parity_case(TWO_JOB_CLUSTER, TWO_JOBS, n_ctmc=512, n_event=96,
                 seed=17)


def test_four_job_contention_parity():
    _parity_case(FOUR_JOB_CLUSTER, FOUR_JOBS, n_ctmc=512, n_event=80,
                 seed=29)


def test_infinite_pool_and_shop_factorizes():
    """With per-job standby headroom, a deep spare pool and an unbounded
    shop, jobs never contend: each job's marginals match an independent
    single-job run within |z| < 3.5."""
    cluster = Params(working_pool_size=220, spare_pool_size=150,
                     job_size=16, job_length=2000.0,
                     random_failure_rate=0.0015,
                     systematic_failure_rate=0.008,
                     recovery_time=10.0, auto_repair_time=120.0,
                     manual_repair_time=300.0, repair_servers=0)
    jobs = (JobSpec(24, 2000.0, warm_standbys=12),
            JobSpec(12, 3000.0, warm_standbys=12))
    out = tm.simulate_multijob_ctmc_sweep([(cluster, jobs)],
                                          n_replicas=512, seed=7,
                                          device="cpu")[0]
    assert float(np.max(out["conservation_err"])) == 0.0
    solo = [cluster.replace(job_size=spec.job_size,
                            job_length=spec.job_length,
                            warm_standbys=spec.warm_standbys)
            for spec in jobs]
    refs = [tv.simulate_ctmc_sweep([p], n_replicas=512, seed=101 + j,
                                   device="cpu")[0]
            for j, p in enumerate(solo)]
    for j, ref in enumerate(refs):
        for metric in ("total_time", "n_failures", "stall_time"):
            z = _z(out["per_job"][j][metric], ref[metric])
            assert abs(z) < Z_MAX, f"job{j} {metric}: z={z:+.2f}"
