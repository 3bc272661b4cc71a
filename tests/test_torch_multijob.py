"""The port's multi-job CTMC engine against the reference's, step by step,
and its exact invariants.

Host side: ``unsupported_reasons_multijob`` and ``resolve_engine_multijob``
give the reference's text on tests/test_multijob_parity.py's gate
configs; the initial state, parameter row and step budget equal the
reference's (``==``).  Then the port's ``_mj_step_u`` in lockstep with the
reference's for 200 steps, each step from the reference's state on the
same numpy uniforms, at two and four jobs with ``repair_servers`` 0 and >
0 (short jobs and tight pools, so the steps hold stalls, hand-offs, queue
admissions and completion releases): integer and count lanes identical,
float lanes within 1e-6 of their scale (of the clock's for
``stall_time``, which adds ``t - stall_start``), with a budget of 0.2% of
row-steps for pick flips within an ulp (the two packages sum the race's
rates in another order and take another float32 ``log``).  Exact
invariants inside the port: ``conservation_err`` is 0 at every step, the
1-job unbounded-shop point equals ``simulate_ctmc_sweep`` bit for bit
without building a multi-job batch, bucketed and unbucketed runs and
``early_exit`` on and off are value-identical on real rows, a mixed-size
grid runs as one batch per job count, and stall ties go to the lowest job
index.  On the card (marked ``gpu``): the sweep through the multi-job
chunk kernel against the plain step loop bit for bit, one chunk-kernel
launch a chunk and no standalone race launch, neither for the 1-job point;
the standalone race, driven through ``_mj_step_u`` and ``ops.event_race``,
at the multi-job widths and on stall ties.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import backend as tb
from repro_torch.core import vectorized as tv
from repro_torch.core import vectorized_multijob as tm
from repro_torch.core.multijob import JobSpec
from repro_torch.core.params import Params
from repro_torch.kernels import ctmc_chunk, des_step, mj_chunk, ops
from repro_torch.kernels.ref import event_race_ref

torch.set_num_threads(1)

F32 = np.float32

#: tests/test_multijob_parity.py's clusters
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

#: short jobs on tight pools with a busy, error-prone shop, so 200 steps
#: hold stalls, FIFO hand-offs, queue admissions and completion releases
LOCK_CLUSTER = Params(
    working_pool_size=60, spare_pool_size=4, job_size=16, job_length=400.0,
    random_failure_rate=0.004, systematic_failure_rate=0.01,
    auto_repair_time=150.0, manual_repair_time=400.0, repair_servers=3,
    diagnosis_uncertainty=0.2)
LOCK_TWO = (JobSpec(32, 300.0, warm_standbys=2),
            JobSpec(16, 500.0, warm_standbys=1))
LOCK_FOUR = (JobSpec(24, 300.0, warm_standbys=2),
             JobSpec(16, 400.0, warm_standbys=1),
             JobSpec(12, 350.0, warm_standbys=1),
             JobSpec(8, 500.0, warm_standbys=1))
LOCKSTEP = {
    "two_shop3": (LOCK_CLUSTER, LOCK_TWO),
    "two_unbounded": (LOCK_CLUSTER.replace(repair_servers=0), LOCK_TWO),
    "four_shop3": (LOCK_CLUSTER.replace(working_pool_size=66), LOCK_FOUR),
    "four_unbounded": (LOCK_CLUSTER.replace(working_pool_size=66,
                                            repair_servers=0), LOCK_FOUR),
}

#: lanes that hold whole numbers or integers: identical on every row-step
#: without a flip
_EXACT = ("phase", "n_runs", "run", "sb", "fw", "fs", "auto", "man", "q",
          "hist", "fleet_total", "n_failures", "n_random_failures",
          "n_systematic_failures", "n_undiagnosed", "n_misdiagnosed",
          "n_preemptions", "n_host_selections", "n_standby_swaps",
          "n_auto_repairs", "n_manual_repairs", "n_failed_repairs",
          "stall_handoffs", "n_shop_queued", "conservation_err")
FLIP_BUDGET = 0.002
#: float lanes that accumulate differences of the clock t, which the two
#: packages hold to an ulp of t (their dt differ by an ulp): compared
#: within 1e-6 of t's scale
_CLOCK_DIFF = ("stall_time",)


@pytest.fixture(scope="module")
def ref():
    """The reference's modules (JAX on the CPU)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import repro.core as jc
    from repro.core import backend as jb
    from repro.core import vectorized_multijob as jm
    return SimpleNamespace(jax=jax, jnp=jnp, core=jc, backend=jb, mj=jm)


def _ref_cluster(ref, p: Params):
    return ref.core.Params.from_dict(p.to_dict())


def _ref_jobs(ref, jobs):
    return tuple(ref.core.JobSpec(j.job_size, j.job_length, j.warm_standbys,
                                  j.start_time) for j in jobs)


# ---------------------------------------------------------------------------
# gates and host-side values
# ---------------------------------------------------------------------------

#: tests/test_multijob_parity.py::test_supports_multijob_gates' configs,
#: and one for every other reason
GATES = {
    "ok": ({}, TWO_JOBS),
    "weibull": ({"failure_distribution": "weibull"}, TWO_JOBS),
    "checkpoint": ({"checkpoint_interval": 100.0}, TWO_JOBS),
    "staggered": ({}, (JobSpec(8, 100.0, 0, start_time=5.0),)),
    "lognormal_repairs": ({"repair_distribution": "lognormal"}, TWO_JOBS),
    "retirement": ({"retirement_threshold": 3}, TWO_JOBS),
    "regeneration": ({"bad_set_regeneration_period": 100.0}, TWO_JOBS),
    "failing_standbys": ({"standbys_can_fail": True}, TWO_JOBS),
    "no_jobs": ({}, ()),
    "everything": ({"failure_distribution": "weibull",
                    "checkpoint_interval": 100.0,
                    "retirement_threshold": 3}, TWO_JOBS),
}


@pytest.mark.parametrize("name", list(GATES))
def test_gates_and_refusals_are_the_references(ref, name):
    kw, jobs = GATES[name]
    port = TWO_JOB_CLUSTER.replace(**kw)
    jc, jj = _ref_cluster(ref, port), _ref_jobs(ref, jobs)
    want = ref.mj.unsupported_reasons_multijob(jc, jj)
    assert tm.unsupported_reasons_multijob(port, jobs) == want
    assert tm.reference_reasons_multijob(port, jobs) == want
    assert tm.supports_multijob(port, jobs) == ref.mj.supports_multijob(jc,
                                                                        jj)
    assert tb.resolve_engine_multijob(port, jobs) \
        == ref.backend.resolve_engine_multijob(jc, jj)
    if not want:
        assert tb.resolve_engine_multijob(port, jobs, "ctmc") == "ctmc"
        return
    with pytest.raises(ValueError) as mine:
        tb.resolve_engine_multijob(port, jobs, "ctmc")
    with pytest.raises(ValueError) as theirs:
        ref.backend.resolve_engine_multijob(jc, jj, "ctmc")
    assert str(mine.value) == str(theirs.value)


def test_sharding_is_refused_naming_its_item():
    """Pinned the port's refusal of replica sharding (ROADMAP queue 1 item
    11) until it was ported: the multi-job engine and ``auto`` now take
    ``engine_shards=2``, and a 2-shard run equals, lane for lane, its two
    per-shard runs (4 replicas each, seeded ``shard_seeds(5, 2)``)."""
    from repro_torch.parallel import shard_seeds
    p = TWO_JOB_CLUSTER.replace(engine_shards=2)
    assert tm.reference_reasons_multijob(p, TWO_JOBS) == []
    assert tm.port_reasons_multijob(p, TWO_JOBS) == []
    assert tm.supports_multijob(p, TWO_JOBS)
    for engine in ("auto", "ctmc"):
        assert tb.resolve_engine_multijob(p, TWO_JOBS, engine) == "ctmc"
    assert tb.resolve_engine_multijob(p, TWO_JOBS, "event") == "event"
    kw = dict(max_steps=192, device="cpu")
    sharded = tm.simulate_multijob_ctmc(p, TWO_JOBS, n_replicas=8, seed=5,
                                        **kw)
    for s, seed in enumerate(shard_seeds(5, 2)):
        part = tm.simulate_multijob_ctmc(TWO_JOB_CLUSTER, TWO_JOBS,
                                         n_replicas=4, seed=seed, **kw)
        rows = slice(4 * s, 4 * s + 4)
        for k, v in part.items():
            if k != "per_job":
                np.testing.assert_array_equal(sharded[k][rows], v, k)
        for j, job in enumerate(part["per_job"]):
            for k, v in job.items():
                got = sharded["per_job"][j][k]
                np.testing.assert_array_equal(
                    got if k == "hist_edges" else got[rows], v, f"{j} {k}")


@pytest.mark.parametrize("name", ["two", "four", "lock_four"])
def test_state_row_and_budget_are_the_references(ref, name):
    cluster, jobs = {"two": (TWO_JOB_CLUSTER, TWO_JOBS),
                     "four": (FOUR_JOB_CLUSTER, FOUR_JOBS),
                     "lock_four": LOCKSTEP["four_shop3"]}[name]
    jc, jj = _ref_cluster(ref, cluster), _ref_jobs(ref, jobs)
    assert tm._mj_initial_counts(cluster, jobs) \
        == ref.mj._mj_initial_counts(jc, jj)
    pts_t = [(cluster, jobs), (cluster.replace(spare_pool_size=3), jobs)]
    pts_j = [(jc, jj), (jc.replace(spare_pool_size=3), jj)]
    ts = tm._mj_initial_state_batch(pts_t, 5, 7)
    js = ref.mj._mj_initial_state_batch(pts_j, 5, 7)
    ts = tv._bucket_pad_state(ts, 2, 5, 4, 8)
    js = ref.mj._mj_bucket_pad(js, 2, 5, 4, 8)
    assert sorted(ts) == sorted(js)
    for k in ts:
        a, b = np.asarray(js[k]), ts[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    pv = tm._mj_params_vector(cluster, jobs)
    jpv = np.asarray(ref.mj._mj_params_vector(jc, jj))
    assert pv.dtype == jpv.dtype == F32
    np.testing.assert_array_equal(pv, jpv)
    assert tm.default_max_steps_multijob(cluster, jobs) \
        == ref.mj.default_max_steps_multijob(jc, jj)


# ---------------------------------------------------------------------------
# the step in lockstep with the reference
# ---------------------------------------------------------------------------

R = 128


@functools.lru_cache(maxsize=None)
def _jax_step(J, channels):
    import jax

    from repro.core import vectorized_multijob as jm
    return jax.jit(functools.partial(jm._mj_step_u, J=J, impl="ref",
                                     hist_channels=channels))


@pytest.mark.parametrize("name", list(LOCKSTEP))
def test_step_lockstep_matches_reference(ref, name):
    cluster, jobs = LOCKSTEP[name]
    jc, jj = _ref_cluster(ref, cluster), _ref_jobs(ref, jobs)
    J = len(jobs)
    channels = ref.mj._selected_channels(jc.histogram)
    assert tv._selected_channels(cluster.histogram) == channels
    step = _jax_step(J, channels)
    js = ref.mj._mj_initial_state_batch([(jc, jj)], R,
                                        jc.max_run_records)
    pv = ref.mj._mj_params_vector(jc, jj)
    tpv = torch.as_tensor(tm._mj_params_vector(cluster, jobs))
    rng = np.random.default_rng(23)
    flips = 0
    seen = dict.fromkeys(("stall", "handoff", "queued", "admit",
                          "complete", "release"), 0)
    for _ in range(200):
        u = rng.uniform(1e-12, 1.0, (R, tm._N_UNIFORMS)).astype(F32)
        before = {k: np.asarray(v) for k, v in js.items()}
        j_out = step(js, ref.jnp.asarray(u), pv)
        t_out = tm._mj_step_u(tv.state_from_numpy(before, "cpu"),
                              torch.as_tensor(u), tpv, J, None, channels)
        assert sorted(t_out) == sorted(j_out)
        same = np.ones(R, bool)
        for k in _EXACT:
            a, b = np.asarray(j_out[k]), t_out[k].numpy()
            same &= (a == b).reshape(R, -1).all(-1)
        flips += int((~same).sum())
        for k, v in j_out.items():
            a, b = np.asarray(v), t_out[k].numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if k in _EXACT or k == "hist_edges":
                continue
            assert a.dtype == F32, k
            assert np.array_equal(np.isinf(a[same]), np.isinf(b[same])), k
            # stall_time adds t - stall_start: an ulp of the clock t
            prev = before["t" if k in _CLOCK_DIFF else k].astype(np.float64)
            prev = prev[np.isfinite(prev)]
            scale = float(np.abs(prev).max()) if prev.size else 0.0
            fin = np.isfinite(a[same])
            np.testing.assert_allclose(b[same][fin], a[same][fin],
                                       rtol=1e-6, atol=1e-6 * scale,
                                       err_msg=k)
        after = {k: np.asarray(v) for k, v in j_out.items()}
        seen["stall"] += int(((after["phase"] == tv.STALL)
                              & (before["phase"] != tv.STALL)).sum())
        seen["handoff"] += int((after["stall_handoffs"]
                                > before["stall_handoffs"]).sum())
        seen["queued"] += int((after["n_shop_queued"]
                               > before["n_shop_queued"]).sum())
        seen["admit"] += int((after["q"].sum((1, 2))
                              < before["q"].sum((1, 2))).sum())
        done = ((after["phase"] == tv.DONE)
                & (before["phase"] != tv.DONE)).any(-1)
        seen["complete"] += int(done.sum())
        seen["release"] += int((done[:, None]
                                & (before["phase"] == tv.STALL)
                                & (after["phase"] == tv.OVERHEAD)).sum())
        js = j_out
    assert flips <= FLIP_BUDGET * R * 200, (flips, name)
    # every path of the step was taken: stalls and FIFO hand-offs, and
    # with a finite shop its queue; releases where stalls are common
    assert seen["stall"] and seen["handoff"] and seen["complete"], seen
    if cluster.repair_servers:
        assert seen["queued"] and seen["admit"] and seen["release"], seen
    else:
        assert seen["queued"] == seen["admit"] == 0, seen
    assert float(np.asarray(js["conservation_err"]).max()) == 0.0


# ---------------------------------------------------------------------------
# exact invariants inside the port
# ---------------------------------------------------------------------------

def _run(points, **kw):
    kw.setdefault("device", "cpu")
    return tm.simulate_multijob_ctmc_sweep(points, **kw)


def _assert_points_equal(a, b, what):
    assert sorted(a) == sorted(b)
    for k in a:
        if k == "per_job":
            assert len(a[k]) == len(b[k])
            for j, (da, db) in enumerate(zip(a[k], b[k])):
                assert sorted(da) == sorted(db)
                for m in da:
                    np.testing.assert_array_equal(
                        da[m], db[m], err_msg=f"{what}: job{j} {m}")
        else:
            np.testing.assert_array_equal(a[k], b[k],
                                          err_msg=f"{what}: {k}")


@pytest.mark.parametrize("name", ["two_shop3", "four_shop3"])
def test_conservation_at_every_step(name):
    cluster, jobs = LOCKSTEP[name]
    out = _run([(cluster, jobs)], n_replicas=64, seed=5)[0]
    # the lane keeps the largest deviation over every step run
    assert float(np.max(out["conservation_err"])) == 0.0
    assert float(out["completed"].min()) == 1.0
    if cluster.repair_servers:
        assert float(np.mean(out["n_shop_queued"])) > 0


def test_one_job_reduction_is_the_single_job_engine(monkeypatch):
    single = Params(working_pool_size=40, spare_pool_size=6, job_size=24,
                    job_length=2000.0, random_failure_rate=0.002,
                    systematic_failure_rate=0.01,
                    auto_repair_time=120.0, manual_repair_time=300.0)
    spec = JobSpec(24, 2000.0, warm_standbys=2)
    want = tv.simulate_ctmc_sweep([single.replace(warm_standbys=2)],
                                  n_replicas=64, seed=13, device="cpu")[0]

    def no_batch(*args, **kwargs):
        raise AssertionError("the 1-job point built a multi-job batch")

    monkeypatch.setattr(tm, "_mj_chunk_loop", no_batch)
    out = _run([(single, (spec,))], n_replicas=64, seed=13)[0]
    assert len(out["per_job"]) == 1
    arrays = out["per_job"][0]
    assert sorted(arrays) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(arrays[k], want[k],
                                      err_msg=f"1-job reduction: {k}")
    np.testing.assert_array_equal(out["makespan"], want["total_time"])
    assert float(np.max(out["conservation_err"])) == 0.0
    assert float(np.max(out["n_shop_queued"])) == 0.0


def test_bucketed_and_unbucketed_are_value_identical_on_real_rows():
    cluster, jobs = LOCKSTEP["two_shop3"]
    points = [(cluster.replace(spare_pool_size=s), jobs) for s in (2, 4, 6)]
    kw = dict(n_replicas=12, seed=3, max_steps=256)
    bucketed = _run(points, bucketed=True, **kw)
    plain = _run(points, bucketed=False, **kw)
    for i, (a, b) in enumerate(zip(bucketed, plain)):
        _assert_points_equal(a, b, f"point {i}")
    assert float(plain[0]["completed"].mean()) > 0.5


def test_early_exit_changes_nothing():
    cluster, jobs = LOCKSTEP["four_shop3"]
    kw = dict(n_replicas=16, seed=8, max_steps=448, chunk_steps=64)
    early = _run([(cluster, jobs)], early_exit=True, **kw)[0]
    full = _run([(cluster, jobs)], early_exit=False, **kw)[0]
    assert float(early["completed"].min()) == 1.0
    _assert_points_equal(early, full, "early_exit")


def test_mixed_size_grid_runs_one_batch_per_job_count(monkeypatch):
    calls = []
    loop = tm._mj_chunk_loop

    def counted(*args, **kwargs):
        calls.append((args[2], args[3], args[7]))      # P, R, J
        return loop(*args, **kwargs)

    monkeypatch.setattr(tm, "_mj_chunk_loop", counted)
    cluster, two = LOCKSTEP["two_shop3"]
    bigger = (JobSpec(28, 350.0, warm_standbys=3),
              JobSpec(20, 450.0, warm_standbys=0))
    four = LOCKSTEP["four_shop3"]
    points = [(cluster, two), four,
              (cluster.replace(spare_pool_size=6, repair_servers=4), bigger)]
    kw = dict(n_replicas=8, seed=4, max_steps=448)
    grid = _run(points, **kw)
    assert sorted(calls) == [(1, 8, 4), (2, 8, 2)]
    # with one step budget a point's rows and draws are its own: a point
    # of each batch equals its run alone
    for i, pt in enumerate(points[:2]):
        alone = _run([pt], **kw)[0]
        _assert_points_equal(grid[i], alone, f"point {i}")
        assert float(alone["completed"].min()) == 1.0


def _tie_state(handoff: bool, device):
    """Three jobs on 8 servers, jobs 1 and 2 stalled at the same instant.

    ``handoff``: job 0 computes on and one of its servers finishes an
    automated repair that heals -- the repaired server goes to a stalled
    job.  Otherwise job 0 completes at once and releases its one server.
    """
    cluster = Params(working_pool_size=8, spare_pool_size=0, job_size=1,
                     job_length=10.0, random_failure_rate=0.0,
                     systematic_failure_rate=0.0,
                     systematic_failure_fraction=0.0,
                     automated_repair_probability=1.0,
                     auto_repair_failure_probability=0.0,
                     auto_repair_time=5.0, histogram=None)
    jobs = (JobSpec(1, 10.0, 0), JobSpec(2, 100.0, 0), JobSpec(2, 100.0, 0))
    s = tm._mj_initial_state_batch([(cluster, jobs)], 2, 0, device)
    s["phase"][:] = torch.tensor([tv.COMPUTE, tv.STALL, tv.STALL],
                                 dtype=torch.int32)
    s["stall_start"][:] = torch.tensor([0.0, 5.0, 5.0])
    if handoff:
        s["work_left"][:, 0] = 1e6
        s["auto"][:, 0, 0] = 1.0
        s["fw"][:, 0] -= 1.0
    else:
        s["work_left"][:, 0] = 1.0
    pv = torch.as_tensor(tm._mj_params_vector(cluster, jobs), device=device)
    u = torch.full((2, tm._N_UNIFORMS), 0.5, device=device)
    return cluster, jobs, s, pv, u


def _assert_tie_to_job1(out, handoff):
    phase = out["phase"].cpu().numpy()
    assert (phase[:, 1] == tv.OVERHEAD).all(), phase
    assert (phase[:, 2] == tv.STALL).all(), phase
    assert (phase[:, 0] == (tv.COMPUTE if handoff else tv.DONE)).all()
    assert float(out["stall_handoffs"].sum()) == (2.0 if handoff else 0.0)
    assert float(out["conservation_err"].max()) == 0.0


@pytest.mark.parametrize("handoff", [True, False])
def test_stall_ties_go_to_the_lowest_job(ref, handoff):
    cluster, jobs, s, pv, u = _tie_state(handoff, "cpu")
    before = tv.state_to_numpy(s)
    out = tm._mj_step_u(s, u, pv, 3, None, ())
    _assert_tie_to_job1(out, handoff)
    j_out = _jax_step(3, ())(before, ref.jnp.asarray(u.numpy()),
                             ref.jnp.asarray(pv.numpy()))
    for k in _EXACT:
        if k in j_out:
            np.testing.assert_array_equal(out[k].numpy(),
                                          np.asarray(j_out[k]), err_msg=k)


def test_kernel_request_on_the_cpu_raises():
    cluster, jobs = LOCKSTEP["two_shop3"]
    with pytest.raises(ValueError, match="mj_chunk impl='cuda'"):
        _run([(cluster, jobs)], n_replicas=4, impl="cuda")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _count_chunks(monkeypatch):
    """Chunks run (each draws once from its seed), counted per call."""
    count = [0]
    seed_fn = tv._chunk_seed

    def counted(seed, i):
        count[0] += 1
        return seed_fn(seed, i)

    monkeypatch.setattr(tv, "_chunk_seed", counted)
    return count


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["two_shop3", "four_unbounded"])
def test_cuda_race_equals_plain_race_bit_for_bit(monkeypatch, name):
    _needs_cuda()
    cluster, jobs = LOCKSTEP[name]
    chunks = _count_chunks(monkeypatch)
    race, fused = des_step.LAUNCHES, mj_chunk.LAUNCHES
    kernel = tm.simulate_multijob_ctmc_sweep(
        [(cluster, jobs), (cluster.replace(spare_pool_size=8), jobs)],
        n_replicas=200, seed=6, device="cuda")
    torch.cuda.synchronize()
    launches = mj_chunk.LAUNCHES - fused
    # a chunk-kernel launch a chunk, with the race fused in: the
    # standalone race never launches
    assert chunks[0] > 0 and launches == chunks[0]
    assert des_step.LAUNCHES == race
    plain = tm.simulate_multijob_ctmc_sweep(
        [(cluster, jobs), (cluster.replace(spare_pool_size=8), jobs)],
        n_replicas=200, seed=6, impl="ref", device="cuda")
    assert mj_chunk.LAUNCHES - fused == launches
    assert des_step.LAUNCHES == race
    for i, (a, b) in enumerate(zip(kernel, plain)):
        _assert_points_equal(a, b, f"point {i}")
        assert float(np.max(a["conservation_err"])) == 0.0


@pytest.mark.gpu
def test_cuda_one_job_point_makes_no_race_launch():
    _needs_cuda()
    single = Params(working_pool_size=40, spare_pool_size=6, job_size=24,
                    job_length=2000.0, random_failure_rate=0.002,
                    systematic_failure_rate=0.01)
    spec = JobSpec(24, 2000.0, warm_standbys=2)
    race, chunks = des_step.LAUNCHES, ctmc_chunk.LAUNCHES
    fused = mj_chunk.LAUNCHES
    out = tm.simulate_multijob_ctmc_sweep([(single, (spec,))],
                                          n_replicas=64, seed=13,
                                          device="cuda")[0]
    assert des_step.LAUNCHES == race and ctmc_chunk.LAUNCHES > chunks
    assert mj_chunk.LAUNCHES == fused
    want = tv.simulate_ctmc_sweep([single.replace(warm_standbys=2)],
                                  n_replicas=64, seed=13, device="cuda")[0]
    for k in want:
        np.testing.assert_array_equal(out["per_job"][0][k], want[k],
                                      err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("handoff", [True, False])
def test_cuda_stall_ties_go_to_the_lowest_job(handoff):
    _needs_cuda()
    _, _, s, pv, u = _tie_state(handoff, "cuda")
    race = des_step.LAUNCHES
    out = tm._mj_step_u(s, u, pv, 3, None, ())
    assert des_step.LAUNCHES == race + 1
    _assert_tie_to_job1(out, handoff)


@pytest.mark.gpu
@pytest.mark.parametrize("J", [2, 4])
def test_cuda_race_at_multijob_widths(J):
    _needs_cuda()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(J)
    B = 1024
    rates = torch.rand((B, 16 * J), generator=gen, device="cuda")
    rates[:, 4 * J:8 * J] *= (torch.arange(4 * J, device="cuda") % 2)
    resid = torch.rand((B, 2 * J), generator=gen, device="cuda") * 5.0
    resid[1::3, 1] = resid[1::3, 0]                   # exact ties
    rates[::4] = 0.0                                  # replicas done:
    resid[::4] = torch.inf                            # no live clock
    u = torch.rand((B, tm._N_UNIFORMS), generator=gen,
                   device="cuda").clamp_min(1e-12)
    before = des_step.LAUNCHES
    dt_k, ev_k = ops.event_race(rates, resid, u[:, 0], u[:, 1])
    assert des_step.LAUNCHES == before + 1
    dt_r, ev_r = event_race_ref(rates, resid, u[:, 0], u[:, 1])
    torch.cuda.synchronize()
    assert torch.equal(ev_k, ev_r)
    assert torch.equal(dt_k.isinf(), dt_r.isinf())
    fin = dt_r.isfinite()
    assert torch.equal(dt_k[fin], dt_r[fin])
    assert bool(dt_k[::4].isinf().all())
