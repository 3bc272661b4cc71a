"""The multi-job chunk kernel (``csrc/mj_chunk.cu`` through
``repro_torch.kernels.mj_chunk``) and its route in
``core.vectorized_multijob._mj_chunk_loop``.

On the CPU: ``mj_chunk_layout`` refuses an unknown lane, a wrong dtype, a
parameter row of the wrong width, a histogram channel the multi-job step
does not carry and a job count above the cap, each by name; ``impl="cuda"``
on CPU tensors raises; ``_mj_chunk_loop`` on the CPU runs the plain step
loop ``_mj_steps`` and launches nothing; the kernel's lanes, in its slot
order, are the reference's state keys and metrics, and its parameter
packing is ``_mj_params_vector``'s, which is the reference's; and the
kernel's plain version, ``_mj_steps`` on the sweep layout (two points, a
parameter row a row, the draw tiled over the points), steps in lockstep
with the reference's step on the same numpy uniforms.

On the card (marked ``gpu``): ``mj_chunk_cuda`` against ``_mj_steps(impl=
"ref")`` bit for bit over every branch of the step -- a finite shop that
queues and admits, an unbounded shop, stall hand-offs and stall ties, a
completion whose release feeds J - 1 stalled jobs, histograms on and off, a
run-duration ring that wraps, J = 1 with a finite shop, J = 2, 3, 4 and
the cap -- over a first launch that leaves its input as it was, a second
in place and a partial final chunk; and the sweep's route: a launch a
chunk, no standalone race, a J above the cap on the runtime-J instance.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import vectorized as tv
from repro_torch.core import vectorized_multijob as tm
from repro_torch.core.multijob import JobSpec
from repro_torch.core.params import Params
from repro_torch.kernels import des_step, mj_chunk

torch.set_num_threads(1)

F32 = np.float32

#: tests/test_torch_multijob.py's lockstep cluster: short jobs on tight
#: pools with a busy, error-prone shop, so a few chunks hold stalls, FIFO
#: hand-offs, queue admissions and completion releases
LOCK = Params(working_pool_size=60, spare_pool_size=4, job_size=16,
              job_length=400.0, random_failure_rate=0.004,
              systematic_failure_rate=0.01, auto_repair_time=150.0,
              manual_repair_time=400.0, repair_servers=3,
              diagnosis_uncertainty=0.2)
TWO = (JobSpec(32, 300.0, 2), JobSpec(16, 500.0, 1))
THREE = (JobSpec(20, 300.0, 2), JobSpec(12, 450.0, 1), JobSpec(8, 350.0, 1))
FOUR = (JobSpec(24, 300.0, 2), JobSpec(16, 400.0, 1), JobSpec(12, 350.0, 1),
        JobSpec(8, 500.0, 1))
EIGHT = tuple(JobSpec(6, 200.0 + 40.0 * j, j % 2) for j in range(8))
#: failure-free clusters whose first step is a scripted hand-off or release
CALM = Params(working_pool_size=8, spare_pool_size=0, job_size=1,
              job_length=10.0, random_failure_rate=0.0,
              systematic_failure_rate=0.0, systematic_failure_fraction=0.0,
              automated_repair_probability=1.0,
              auto_repair_failure_probability=0.0, auto_repair_time=5.0,
              histogram=None)
TIE_JOBS = (JobSpec(1, 10.0, 0), JobSpec(2, 100.0, 0), JobSpec(2, 100.0, 0))
RELEASE_JOBS = (JobSpec(6, 10.0, 0), JobSpec(2, 100.0, 0),
                JobSpec(2, 100.0, 0), JobSpec(2, 100.0, 0))

#: case -> (points, replicas a point, ring records)
CASES = {
    "ties_handoff": ([(CALM, TIE_JOBS)], 8, 4),
    "ties_release": ([(CALM, TIE_JOBS)], 8, 4),
    "release_feeds_three": ([(CALM.replace(working_pool_size=20),
                              RELEASE_JOBS)], 8, 4),
    "J2_shop3": ([(LOCK, TWO)], 48, 4),
    "J2_unbounded": ([(LOCK.replace(repair_servers=0), TWO)], 48, 4),
    "J3_grid_nohist": ([(LOCK.replace(spare_pool_size=s, repair_servers=r,
                                      histogram=None), THREE)
                        for s in (2, 6) for r in (0, 2)], 16, 4),
    "J4_shop3": ([(LOCK.replace(working_pool_size=66), FOUR)], 40, 77),
    "J4_unbounded_ring3": ([(LOCK.replace(working_pool_size=66,
                                          repair_servers=0), FOUR)], 40, 3),
    "J1_shop2": ([(LOCK.replace(repair_servers=2),
                   (JobSpec(40, 600.0, 3),))], 48, 4),
    "J8_shop4_cap": ([(LOCK.replace(working_pool_size=70, repair_servers=4),
                       EIGHT)], 24, 4),
}


@pytest.fixture(scope="module")
def ref():
    """The reference's modules (JAX on the CPU)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import repro.core as jc
    from repro.core import vectorized_multijob as jm
    return SimpleNamespace(jax=jax, jnp=jnp, core=jc, mj=jm)


def _case(name, device):
    """(state, pv, R, P, J, channels) of a case on ``device``."""
    pts, R, max_runs = CASES[name]
    P, J = len(pts), len(pts[0][1])
    rows = np.stack([tm._mj_params_vector(c, js) for c, js in pts])
    pv = torch.as_tensor(rows[0] if P == 1 else np.repeat(rows, R, axis=0),
                         device=device)
    state = tm._mj_initial_state_batch(pts, R, max_runs, device)
    if name.startswith("ties_"):
        # jobs 1 and 2 stalled at the same instant; job 0 computes and one
        # of its servers finishes a healing repair, or completes at once
        state["phase"][:] = torch.tensor([tv.COMPUTE, tv.STALL, tv.STALL],
                                         dtype=torch.int32)
        state["stall_start"][:] = torch.tensor([0.0, 5.0, 5.0])
        if name == "ties_handoff":
            state["work_left"][:, 0] = 1e6
            state["auto"][:, 0, 0] = 1.0
            state["fw"][:, 0] -= 1.0
        else:
            state["work_left"][:, 0] = 1.0
    elif name == "release_feeds_three":
        # job 0 completes at once; jobs 1-3 stalled, the latest first
        state["phase"][:] = torch.tensor(
            [tv.COMPUTE, tv.STALL, tv.STALL, tv.STALL], dtype=torch.int32)
        state["stall_start"][:] = torch.tensor([0.0, 5.0, 3.0, 4.0])
        state["work_left"][:, 0] = 1.0
    return state, pv, R, P, J, tv._selected_channels(pts[0][0].histogram)


def _draw(R, n_steps, i, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(tv._chunk_seed(11, i))
    return torch.rand((n_steps, tv._next_pow2(R), tm._N_UNIFORMS),
                      generator=gen, device=device).clamp_min_(1e-12)


# ---------------------------------------------------------------------------
# on the CPU: layout, refusals, route, packing
# ---------------------------------------------------------------------------

def _cpu_layout(name="J2_shop3", n_steps=4):
    state, pv, R, P, J, ch = _case(name, "cpu")
    return state, _draw(R, n_steps, 0, "cpu"), pv, R, P, J, ch


def test_layout_refuses_an_unknown_key():
    state, us, pv, R, P, J, ch = _cpu_layout()
    state["age"] = torch.zeros_like(state["t"])
    with pytest.raises(ValueError, match=r"state keys \['age'\] are lanes "
                       "the kernel does not carry"):
        mj_chunk.mj_chunk_layout(state, us, pv, R, P, J, ch)
    del state["age"], state["q"]
    with pytest.raises(ValueError, match=r"state lacks \['q'\]"):
        mj_chunk.mj_chunk_layout(state, us, pv, R, P, J, ch)


def test_layout_refuses_a_wrong_dtype_or_shape():
    state, us, pv, R, P, J, ch = _cpu_layout()
    bad = dict(state, n_runs=state["n_runs"].to(torch.float32))
    with pytest.raises(ValueError, match="n_runs has dtype torch.float32; "
                       "the kernel's is torch.int32"):
        mj_chunk.mj_chunk_layout(bad, us, pv, R, P, J, ch)
    bad = dict(state, q=state["q"][:, :1].contiguous())
    with pytest.raises(ValueError, match=r"q has shape \(48, 1, 4\), not "
                       r"\(48, 2, 4\)"):
        mj_chunk.mj_chunk_layout(bad, us, pv, R, P, J, ch)
    with pytest.raises(ValueError, match="pv has 17 columns; the 2-job "
                       "step reads 16"):
        mj_chunk.mj_chunk_layout(state, us, torch.zeros((48, 17)), R, P, J,
                                 ch)
    with pytest.raises(ValueError, match=r"pv \(4, 16\) is neither one row"):
        mj_chunk.mj_chunk_layout(state, us, torch.zeros((4, 16)), R, P, J,
                                 ch)
    with pytest.raises(ValueError, match=r"uniforms \(4, 64, 8\) are not"):
        mj_chunk.mj_chunk_layout(state, us[..., :8].contiguous(), pv, R, P,
                                 J, ch)
    with pytest.raises(ValueError, match="histogram channels .*goodput.* "
                       "are not 1-3 of"):
        mj_chunk.mj_chunk_layout(state, us, pv, R, P, J,
                                 ("run_duration", "recovery", "goodput"))


@pytest.mark.parametrize("J", [0, mj_chunk.MAX_JOBS + 1])
def test_layout_refuses_jobs_outside_the_cap(J):
    state, us, pv, R, P, _, ch = _cpu_layout()
    with pytest.raises(ValueError, match=rf"mj_chunk: {J} jobs; the kernel "
                       rf"takes 1..{mj_chunk.MAX_JOBS} jobs a cluster .*"
                       r'impl="ref"'):
        mj_chunk.mj_chunk_layout(state, us, pv, R, P, J, ch)


def test_kernel_request_on_the_cpu_raises():
    state, us, pv, R, P, J, ch = _cpu_layout()
    with pytest.raises(ValueError, match="mj_chunk impl='cuda' needs CUDA "
                       "tensors"):
        tm.simulate_multijob_ctmc_sweep([(LOCK, TWO)], n_replicas=4,
                                        impl="cuda", device="cpu")
    with pytest.raises(ValueError, match="mj_chunk: the state is on cpu, "
                       "not a CUDA device"):
        mj_chunk.mj_chunk_cuda(state, us, pv, R, P, J, ch)


def test_cpu_chunk_loop_runs_the_plain_step_loop(monkeypatch):
    calls = []
    steps = tm._mj_steps

    def counted(state, us, *args, **kwargs):
        calls.append(us.shape[0])
        return steps(state, us, *args, **kwargs)

    monkeypatch.setattr(tm, "_mj_steps", counted)
    launches, race = mj_chunk.LAUNCHES, des_step.LAUNCHES
    out = tm.simulate_multijob_ctmc(LOCK, TWO, n_replicas=8, seed=2,
                                    max_steps=100, chunk_steps=64,
                                    device="cpu")
    assert calls == [64, 36]
    assert mj_chunk.LAUNCHES == launches and des_step.LAUNCHES == race
    assert float(np.max(out["conservation_err"])) == 0.0


def test_lanes_and_packing_are_the_references(ref):
    pts = [(LOCK, FOUR), (LOCK.replace(spare_pool_size=6), FOUR)]
    J = len(FOUR)
    jpts = [(ref.core.Params.from_dict(c.to_dict()),
             tuple(ref.core.JobSpec(j.job_size, j.job_length,
                                    j.warm_standbys) for j in js))
            for c, js in pts]
    # the kernel's lanes are the reference's state, metric for metric
    js = ref.mj._mj_initial_state_batch(jpts, 3, 5)
    assert set(js) == set(mj_chunk._KNOWN)
    assert mj_chunk.JOB_METRICS == tm._MJ_JOB_METRICS \
        == tuple(ref.mj._MJ_JOB_METRICS)
    assert mj_chunk.CLUSTER_METRICS == tm._MJ_CLUSTER_METRICS \
        == tuple(ref.mj._MJ_CLUSTER_METRICS)
    assert mj_chunk.N_UNIFORMS == tm._N_UNIFORMS == ref.mj._N_UNIFORMS
    # the parameter row: 14 shared columns, then a target a job
    for (c, jobs), (jcl, jjobs) in zip(pts, jpts):
        row = tm._mj_params_vector(c, jobs)
        np.testing.assert_array_equal(
            row, np.asarray(ref.mj._mj_params_vector(jcl, jjobs)))
        assert row.shape == (mj_chunk.N_SHARED_COLS + J,)
        assert list(row[mj_chunk.N_SHARED_COLS:]) \
            == [j.warm_standbys for j in jobs]
        assert row[mj_chunk.N_SHARED_COLS - 1] == c.repair_servers
    # the launch's struct carries each lane in the kernel's slot order
    state = tm._mj_initial_state_batch(pts, 3, 5, "cpu")
    us = _draw(3, 2, 0, "cpu")
    rows = np.stack([tm._mj_params_vector(c, js) for c, js in pts])
    for pv, stride in ((torch.as_tensor(rows[0]), 0),
                       (torch.as_tensor(np.repeat(rows, 3, axis=0)),
                        mj_chunk.N_SHARED_COLS + J)):
        layout = mj_chunk.mj_chunk_layout(state, us, pv, 3, 2, J,
                                          tv._selected_channels(
                                              LOCK.histogram))
        assert layout["pv_stride"] == stride
        args = mj_chunk._args(layout)
        for field, names in (("block", mj_chunk.BLOCKS),
                             ("pool", mj_chunk.POOLS),
                             ("job_lane", mj_chunk.JOB_LANES),
                             ("job_metric", mj_chunk.JOB_METRICS),
                             ("cluster_metric", mj_chunk.CLUSTER_METRICS)):
            assert list(getattr(args, field)) \
                == [state[k].data_ptr() for k in names], field
        assert args.pv == pv.data_ptr() and args.n_jobs == J
        assert args.max_runs == 5 and args.n_sel == 3
        assert list(args.chan) == [0, 1, 2]
        assert args.n_edges == LOCK.histogram.n_counts - 1
        assert args.rows_per_block == mj_chunk.rows_per_block(
            J, args.n_edges)


def test_block_width_fits_shared_memory():
    assert mj_chunk.rows_per_block(3, 130) == 128
    assert mj_chunk.rows_per_block(8, 130) == 128
    assert mj_chunk.rows_per_block(8, 20000) == 64
    assert mj_chunk.rows_per_block(8, 20000, widest=32) == 32
    assert mj_chunk.rows_per_block(3, 130, widest=64) == 64
    with pytest.raises(ValueError, match="bytes of shared memory a block"):
        mj_chunk.rows_per_block(8, 50000)


@functools.lru_cache(maxsize=None)
def _jax_step(J, channels):
    import jax

    from repro.core import vectorized_multijob as jm
    return jax.jit(functools.partial(jm._mj_step_u, J=J, impl="ref",
                                     hist_channels=channels))


def test_plain_chunk_steps_in_lockstep_with_the_reference(ref):
    """The kernel's plain version on the sweep layout: each step of
    ``_mj_steps`` (a parameter row a row, the draw sliced to R and tiled
    over the points) from the reference's state equals the reference's
    step on the same tiled uniforms: integer lanes identical, float lanes
    within 1e-6 of their scale, with test_torch_multijob.py's budget of
    pick flips within an ulp."""
    R, P = 24, 2
    pts = [(LOCK, THREE), (LOCK.replace(spare_pool_size=6,
                                        repair_servers=2), THREE)]
    J = len(THREE)
    jpts = [(ref.core.Params.from_dict(c.to_dict()),
             tuple(ref.core.JobSpec(j.job_size, j.job_length,
                                    j.warm_standbys) for j in js))
            for c, js in pts]
    channels = tv._selected_channels(LOCK.histogram)
    step = _jax_step(J, channels)
    js = ref.mj._mj_initial_state_batch(jpts, R, 6)
    rows = np.stack([tm._mj_params_vector(c, jobs) for c, jobs in pts])
    pv = np.repeat(rows, R, axis=0)
    rng = np.random.default_rng(31)
    exact = ("phase", "n_runs", "run", "sb", "fw", "fs", "auto", "man", "q",
             "hist", "n_failures", "n_host_selections", "n_shop_queued",
             "stall_handoffs", "conservation_err")
    flips = 0
    for _ in range(64):
        # a draw of next_pow2(R) rows, of which the first R serve
        u = rng.uniform(1e-12, 1.0, (1, 32, tm._N_UNIFORMS)).astype(F32)
        before = {k: np.asarray(v) for k, v in js.items()}
        js = step(js, ref.jnp.asarray(np.tile(u[0, :R], (P, 1))),
                  ref.jnp.asarray(pv))
        out = tm._mj_steps(tv.state_from_numpy(before, "cpu"),
                           torch.as_tensor(u), torch.as_tensor(pv), R, P, J,
                           "ref", channels)
        same = np.ones(P * R, bool)
        for k in exact:
            same &= (np.asarray(js[k]) == out[k].numpy()).reshape(
                P * R, -1).all(-1)
        flips += int((~same).sum())
        for k in ("t", "work_left", "timer", "useful_work", "cur_run",
                  "run_durations"):
            a, b = np.asarray(js[k])[same], out[k].numpy()[same]
            fin = np.isfinite(a)
            assert np.array_equal(fin, np.isfinite(b)), k
            scale = float(np.abs(a[fin]).max()) if fin.any() else 0.0
            np.testing.assert_allclose(b[fin], a[fin], rtol=1e-6,
                                       atol=1e-6 * scale, err_msg=k)
    assert flips <= 0.002 * P * R * 64, flips
    assert float(np.asarray(js["n_shop_queued"]).sum()) > 0
    assert float(np.asarray(js["stall_handoffs"]).sum()) > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _bits_differing(got, want):
    assert sorted(got) == sorted(want)
    n = 0
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype.is_floating_point:
            n += int((g.view(torch.int32) != w.view(torch.int32)).sum())
        else:
            n += int((g != w).sum())
    return n


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_cuda_kernel_equals_plain_chunk_bit_for_bit(name):
    """Three chunks: a first launch that leaves its input as it was, a
    second in place, and a partial final chunk in place; every lane bit
    for bit against the plain step loop on the same draws."""
    _needs_cuda()
    state, pv, R, P, J, ch = _case(name, "cuda")
    launches, steps = mj_chunk.LAUNCHES, mj_chunk.STEPS
    by_j, race = mj_chunk.LAUNCHES_BY_J[J], des_step.LAUNCHES
    want = state
    got = state
    for i, n_steps in enumerate((64, 64, 37)):
        us = _draw(R, n_steps, i, "cuda")
        before = {k: v.clone() for k, v in got.items()}
        out = mj_chunk.mj_chunk_cuda(got, us, pv, R, P, J, ch,
                                     inplace=i > 0)
        if i == 0:
            assert _bits_differing(got, before) == 0     # input untouched
        else:
            assert all(out[k] is got[k] for k in got)    # updated in place
        got = out
        want = tm._mj_steps(want, us, pv, R, P, J, "ref", ch)
        torch.cuda.synchronize()
        assert _bits_differing(got, want) == 0, (name, i)
    assert mj_chunk.LAUNCHES - launches == 3
    assert mj_chunk.LAUNCHES_BY_J[J] - by_j == 3
    assert mj_chunk.STEPS - steps == 64 + 64 + 37
    assert des_step.LAUNCHES == race
    assert float(want["conservation_err"].max()) == 0.0
    # the branches each case is for were taken
    pts, _, max_runs = CASES[name]
    if name.startswith("ties_") or name == "release_feeds_three":
        phase = want["phase"].cpu()
        assert bool((phase[:, 0] == tv.DONE).all())
    if name == "ties_handoff":
        assert float(want["stall_handoffs"].min()) >= 1.0
    if name == "release_feeds_three":
        assert float(want["n_host_selections"][:, 1:].min()) >= 1.0
    if pts[0][0].repair_servers and "shop" in name:
        assert float(want["n_shop_queued"].sum()) > 0
        assert float(want["stall_handoffs"].sum()) > 0
    if max_runs < 10 and not name.startswith(("ties_", "release")):
        assert int(want["n_runs"].max()) > max_runs       # the ring wraps


@pytest.mark.gpu
def test_cuda_sweep_launches_the_kernel_a_chunk(monkeypatch):
    """The sweep's route on the card: one launch a chunk (a partial last
    chunk included), no standalone race, the whole result bit for bit the
    plain step loop's."""
    _needs_cuda()
    chunks = [0]
    seed_fn = tv._chunk_seed

    def counted(seed, i):
        chunks[0] += 1
        return seed_fn(seed, i)

    monkeypatch.setattr(tv, "_chunk_seed", counted)
    points = [(LOCK.replace(spare_pool_size=s), THREE) for s in (2, 4, 6)]
    launches, steps, race = (mj_chunk.LAUNCHES, mj_chunk.STEPS,
                             des_step.LAUNCHES)
    kw = dict(n_replicas=100, seed=9, max_steps=300, chunk_steps=64,
              early_exit=False)
    kernel = tm.simulate_multijob_ctmc_sweep(points, device="cuda", **kw)
    torch.cuda.synchronize()
    assert chunks[0] == 5                                # 4 x 64 + 44
    assert mj_chunk.LAUNCHES - launches == 5
    assert mj_chunk.STEPS - steps == 300
    assert des_step.LAUNCHES == race
    plain = tm.simulate_multijob_ctmc_sweep(points, device="cuda",
                                            impl="ref", **kw)
    assert chunks[0] == 10 and mj_chunk.LAUNCHES - launches == 5
    for a, b in zip(kernel, plain):
        for k in a:
            if k == "per_job":
                for da, db in zip(a[k], b[k]):
                    for m in da:
                        np.testing.assert_array_equal(da[m], db[m],
                                                      err_msg=m)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert float(np.max(a["conservation_err"])) == 0.0


@pytest.mark.gpu
def test_cuda_jobs_above_the_cap_are_refused():
    """Above the template instances' cap the layout still refuses (pinned
    on the CPU), and the engine routes the chunk to the runtime-J
    instance instead: nine jobs under the default ``impl`` run a launch a
    chunk of it, bit for bit ``impl="ref"``."""
    _needs_cuda()
    jobs = tuple(JobSpec(4, 100.0, 0) for _ in range(mj_chunk.MAX_JOBS + 1))
    cluster = LOCK.replace(working_pool_size=60)
    launches, rt = mj_chunk.LAUNCHES, mj_chunk.LAUNCHES_RT
    by_j = dict(mj_chunk.LAUNCHES_BY_J)
    got = tm.simulate_multijob_ctmc(cluster, jobs, n_replicas=64,
                                    max_steps=200, early_exit=False,
                                    device="cuda")
    assert mj_chunk.LAUNCHES_RT - rt == 4                # 3 x 64 + 8
    assert mj_chunk.LAUNCHES - launches == 4
    assert mj_chunk.LAUNCHES_BY_J == by_j
    out = tm.simulate_multijob_ctmc(cluster, jobs, n_replicas=64,
                                    max_steps=200, early_exit=False,
                                    impl="ref", device="cuda")
    assert mj_chunk.LAUNCHES - launches == 4
    assert len(out["per_job"]) == mj_chunk.MAX_JOBS + 1
    for k in out:
        if k == "per_job":
            for da, db in zip(got[k], out[k]):
                for m in db:
                    np.testing.assert_array_equal(da[m], db[m], err_msg=m)
        else:
            np.testing.assert_array_equal(got[k], out[k], err_msg=k)
