"""The port's multi-job backend and MultiJobSweep against the reference's.

``MultiJobReplications`` has the reference's fields, and the reference's
statistics on the same arrays; on the event route its statistics equal
the reference's exactly, and
``aggregate_multijob_arrays`` gives the reference's statistics on the
same arrays.  Fed the same point arrays, the reference's ``MultiJobSweep``
writes the port's rows; each on its own engine, the rows agree within
|z| < 3.5 on every column of a small capacity grid.  Seeds are fixed, so
every run checks the same cases.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.core import backend as tb
from repro_torch.core import metrics as tmet
from repro_torch.core import sweeps as tsw
from repro_torch.core import vectorized_multijob as tm
from repro_torch.core.multijob import JobSpec
from repro_torch.core.params import Params

torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import repro.core as jc  # noqa: E402
from repro.core import backend as jb  # noqa: E402
from repro.core import metrics as jmet  # noqa: E402
from repro.core import vectorized_multijob as jm  # noqa: E402

Z_MAX = 3.5

#: tests/test_multijob_parity.py's two-job cluster
TWO_JOB_CLUSTER = Params(
    working_pool_size=110, spare_pool_size=16, job_size=16,
    job_length=4000.0, random_failure_rate=0.001,
    systematic_failure_rate=0.005, auto_repair_time=180.0,
    manual_repair_time=480.0, repair_servers=6)
TWO_JOBS = (JobSpec(32, 4000.0, warm_standbys=2),
            JobSpec(16, 6000.0, warm_standbys=1))


def _ref_cluster(p: Params):
    return jc.Params.from_dict(p.to_dict())


def _ref_jobs(jobs):
    return tuple(jc.JobSpec(j.job_size, j.job_length, j.warm_standbys,
                            j.start_time) for j in jobs)


def test_backend_replications_have_the_references_fields():
    fields = [f.name for f in dataclasses.fields(tb.MultiJobReplications)]
    assert fields == [f.name for f in
                      dataclasses.fields(jb.MultiJobReplications)]
    rep = tb.run_replications_multijob(TWO_JOB_CLUSTER, TWO_JOBS, n=64,
                                       engine="auto", base_seed=11,
                                       device="cpu")
    assert rep.engine == "ctmc" and rep.n == 64
    assert len(rep.per_job) == len(TWO_JOBS)
    assert rep.fleet["makespan"].mean > 0
    assert rep.fleet["conservation_err"].maximum == 0.0
    assert set(rep.histograms) >= {"run_duration", "recovery", "waiting"}
    for jr in rep.per_job:
        assert jr.engine == "ctmc" and jr.stats["total_time"].mean > 0
        assert all(np.shape(v)[0] == 64 for v in jr.arrays.values()
                   if np.ndim(v) and v is not jr.arrays.get("hist_edges"))
    # the same arrays through the reference's wrapper: the same statistics
    point = tm.simulate_multijob_ctmc(TWO_JOB_CLUSTER, TWO_JOBS,
                                      n_replicas=64, seed=11, device="cpu")
    ref = jb._multijob_from_arrays(point, 64)
    assert (rep.engine, rep.n) == (ref.engine, ref.n)
    _assert_stats_equal(rep.fleet, ref.fleet, "fleet")
    for j, (a, b) in enumerate(zip(rep.per_job, ref.per_job)):
        _assert_stats_equal(a.stats, b.stats, f"job{j}")
    for ch, h in rep.histograms.items():
        np.testing.assert_array_equal(h.counts, ref.histograms[ch].counts)


def _assert_stats_equal(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        sa, sb = a[k], b[k]
        for f in dataclasses.fields(sa):
            x, y = getattr(sa, f.name), getattr(sb, f.name)
            if isinstance(x, dict):
                assert x.keys() == y.keys()
                x, y = list(x.values()), list(y.values())
            np.testing.assert_array_equal(np.asarray(x, float),
                                          np.asarray(y, float),
                                          err_msg=f"{what} {k}.{f.name}")


def test_event_route_statistics_are_the_references():
    small = TWO_JOB_CLUSTER.replace(job_length=800.0)
    jobs = (JobSpec(32, 800.0, warm_standbys=2),
            JobSpec(16, 1200.0, warm_standbys=1))
    mine = tb.run_replications_multijob(small, jobs, n=6, engine="event",
                                        base_seed=3)
    ref = jb.run_replications_multijob(_ref_cluster(small), _ref_jobs(jobs),
                                       n=6, engine="event", base_seed=3)
    assert mine.engine == ref.engine == "event"
    _assert_stats_equal(mine.fleet, ref.fleet, "fleet")
    for j, (a, b) in enumerate(zip(mine.per_job, ref.per_job)):
        _assert_stats_equal(a.stats, b.stats, f"job{j}")


def test_aggregate_multijob_arrays_is_the_references():
    point = tm.simulate_multijob_ctmc_sweep([(TWO_JOB_CLUSTER, TWO_JOBS)],
                                            n_replicas=32, seed=2,
                                            device="cpu")[0]
    mine = tmet.aggregate_multijob_arrays(point)
    ref = jmet.aggregate_multijob_arrays(point)
    _assert_stats_equal(mine["fleet"], ref["fleet"], "fleet")
    for j, (a, b) in enumerate(zip(mine["per_job"], ref["per_job"])):
        _assert_stats_equal(a, b, f"job{j}")
    for ch, h in mine["histograms"].items():
        np.testing.assert_array_equal(h.counts, ref["histograms"][ch].counts)


SWEEP_GRID = dict(parameter="spare_pool_size", values=[8, 16],
                  parameter_b="repair_servers", values_b=[3, 6],
                  base_seed=3)


def test_multijob_sweep_rows_are_the_references_on_the_same_arrays(
        monkeypatch):
    """The sweep's plumbing, exactly: fed the port engine's point arrays,
    the reference's MultiJobSweep writes the port's rows."""
    mine = tsw.MultiJobSweep("capacity", TWO_JOBS, n_replications=32,
                             base_params=TWO_JOB_CLUSTER, device="cpu",
                             **SWEEP_GRID)
    points = []
    sweep = tm.simulate_multijob_ctmc_sweep

    def keep(*args, **kwargs):
        points.extend(sweep(*args, **kwargs))
        return points

    monkeypatch.setattr(tm, "simulate_multijob_ctmc_sweep", keep)
    rows = mine.run()
    assert len(points) == 4
    monkeypatch.setattr(jm, "simulate_multijob_ctmc_sweep",
                        lambda *args, **kwargs: points)
    ref = jc.MultiJobSweep("capacity", _ref_jobs(TWO_JOBS),
                           n_replications=32,
                           base_params=_ref_cluster(TWO_JOB_CLUSTER),
                           **SWEEP_GRID).run()
    cols = mine.columns()
    assert rows.parameter_names == ref.parameter_names
    for p, q in zip(rows.points, ref.points):
        assert (p.values, p.engine, p.n) == (q.values, q.engine, q.n)
        _assert_stats_equal(p.stats, q.stats, str(p.values))
    assert rows.to_rows(cols) == ref.to_rows(cols)


def test_multijob_sweep_rows_agree_with_the_references():
    """Each engine on its own draws: every column's mean within |z| <
    3.5 at every point."""
    n = 256
    mine = tsw.MultiJobSweep("capacity", TWO_JOBS, n_replications=n,
                             base_params=TWO_JOB_CLUSTER, device="cpu",
                             **SWEEP_GRID)
    ref = jc.MultiJobSweep("capacity", _ref_jobs(TWO_JOBS),
                           n_replications=n,
                           base_params=_ref_cluster(TWO_JOB_CLUSTER),
                           **SWEEP_GRID)
    cols = mine.columns()
    assert cols == ref.columns()
    rows, ref_rows = mine.run(), ref.run()
    assert [p.engine for p in rows.points] == ["ctmc"] * 4
    assert [p.values for p in rows.points] == [p.values
                                               for p in ref_rows.points]
    for p, q in zip(rows.points, ref_rows.points):
        for col in cols:
            a, b = p.stats[col], q.stats[col]
            se = math.sqrt((a.std ** 2 + b.std ** 2) / n)
            z = (a.mean - b.mean) / max(se, 1e-12)
            assert abs(z) < Z_MAX, f"{p.values} {col}: z={z:+.2f}"
