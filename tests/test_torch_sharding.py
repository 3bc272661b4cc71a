"""Replica sharding of the port's CTMC engines: the exactness contract.

The contract of tests/test_replica_sharding.py and docs/scaling.md, as the
port's own invariants (torch's streams cannot reproduce threefry's bits):

* one shard is the unsharded run bit for bit, for ``simulate_ctmc``, the
  sweep, the ``Params.engine_shards`` knob and the multi-job engine;
* shard ``s`` of an ``n``-shard run is bit for bit, on every output lane
  (histograms and run-duration rings included), an independent unsharded
  run over its ``R / n`` replicas seeded ``shard_seeds(seed, n)[s]``, for
  n = 2 and 4, the single-job engine, a padded sweep and the two- and
  four-job clusters of tests/test_multijob_parity.py;
* a sharded sweep equals its sharded single-point runs, and the histogram
  merge is exact;
* a shard count that does not divide R, missing cards, a mixed
  ``engine_shards`` grid and bad knob values are refused, with the
  reference's words where it has them.

On the CPU the shards run in turn on the one host device.  On the card
(marked ``gpu``): with two or more cards a 2-shard run on ``cuda:0`` and
``cuda:1`` is its per-shard runs; with one, a 2-shard request raises,
naming the card count.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import backend as tb
from repro_torch.core import vectorized as tv
from repro_torch.core import vectorized_multijob as tm
from repro_torch.core.multijob import JobSpec
from repro_torch.core.faultdomains import FaultTopology
from repro_torch.core.params import Params
from repro_torch.parallel import sharding as rs

torch.set_num_threads(1)


def small_params(**kw):
    """tests/test_replica_sharding.py's config."""
    base = dict(working_pool_size=32, spare_pool_size=4, job_size=16,
                job_length=500.0)
    base.update(kw)
    return Params(**base)


#: tests/test_multijob_parity.py's clusters
TWO_JOB = (Params(working_pool_size=110, spare_pool_size=16, job_size=16,
                  job_length=4000.0, random_failure_rate=0.001,
                  systematic_failure_rate=0.005, auto_repair_time=180.0,
                  manual_repair_time=480.0, repair_servers=6),
           (JobSpec(32, 4000.0, warm_standbys=2),
            JobSpec(16, 6000.0, warm_standbys=1)))
FOUR_JOB = (Params(working_pool_size=110, spare_pool_size=12, job_size=16,
                   job_length=3000.0, random_failure_rate=0.001,
                   systematic_failure_rate=0.005, auto_repair_time=150.0,
                   manual_repair_time=420.0, repair_servers=5),
            (JobSpec(24, 3000.0, warm_standbys=2),
             JobSpec(16, 4000.0, warm_standbys=1),
             JobSpec(12, 3500.0, warm_standbys=1),
             JobSpec(8, 5000.0, warm_standbys=1)))


def assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), path


def rows_of(result, rows, R):
    """The replica rows ``rows`` of a result dict (the shared bin edges
    whole)."""
    if isinstance(result, dict):
        return {k: rows_of(v, rows, R) for k, v in result.items()}
    if isinstance(result, list):
        return [rows_of(v, rows, R) for v in result]
    v = np.asarray(result)
    return v[rows] if v.ndim and v.shape[0] == R else v


# ---------------------------------------------------------------------------
# seeds, devices, lane specs
# ---------------------------------------------------------------------------

def test_shard_seeds_mesh1_is_the_seed():
    assert rs.shard_seeds(3, 1) == [3]
    assert rs.shard_seeds(2 ** 70, 1) == [2 ** 70]


def test_shard_seeds_are_folded_distinct_and_fixed():
    seeds = rs.shard_seeds(3, 4)
    assert len(set(seeds)) == 4 and seeds == rs.shard_seeds(3, 4)
    assert all(0 <= s < 2 ** 64 for s in seeds)
    # a shard's first seeds are not the first chunks' of its base seed, nor
    # the shards of another seed, nor a prefix shifted across counts
    assert not set(seeds) & {tv._chunk_seed(3, i) for i in range(64)}
    assert not set(seeds) & set(rs.shard_seeds(4, 4))
    assert rs.shard_seeds(3, 2) == seeds[:2]
    assert 3 not in seeds
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        rs.shard_seeds(3, 0)


def test_replica_mesh_devices(monkeypatch):
    assert rs.replica_mesh(4, "cpu") == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        rs.replica_mesh(0, "cpu")
    # on the card, shard s on cuda:s; the count is all it reads
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert rs.replica_mesh(2, "cuda") == [torch.device("cuda", 0),
                                          torch.device("cuda", 1)]
    assert rs.replica_mesh(1, "cuda:1") == [torch.device("cuda", 1)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"needs 2 CUDA devices.* only 1 "):
        rs.replica_mesh(2, "cuda")


def test_replica_state_specs():
    state = tv._initial_state(small_params(), 4)
    specs = rs.replica_state_specs(state, tv._UNBATCHED_STATE)
    assert specs["hist_edges"] is None
    assert {v for k, v in specs.items() if k != "hist_edges"} \
        == {rs.REPLICA_AXIS}


def test_shard_and_gather_are_inverse():
    pts = [small_params(), small_params(spare_pool_size=8)]
    state = tv._initial_state_batch(pts, 8, 4, "cpu")
    state["t"] = torch.arange(16, dtype=torch.float32)
    mesh = rs.replica_mesh(4, "cpu")
    parts = [tv._shard_state(state, 2, 8, s, mesh) for s in range(4)]
    assert parts[1]["t"].tolist() == [2.0, 3.0, 10.0, 11.0]
    assert_same(tv._gather_shards(parts, 2, 2, "cpu"), state)


def test_drive_launches_every_shard_before_reading_any(monkeypatch):
    """Chunk i is launched on every running shard before the early-exit
    reads (which sync the host with a card), and a finished shard stops
    while the others go on."""
    log = []

    def run(s):
        def chunk(state, i, n):
            log.append(("chunk", s, i, n))
            return {"left": state["left"] - 1}
        return chunk

    def active(state):
        log.append(("read", int(state["left"])))
        return int(state["left"]) > 0

    monkeypatch.setattr(tv, "_any_active", active)
    runs = [(run(0), {"left": 1}), (run(1), {"left": 4})]
    out = tv._drive(runs, 3, 64, 5, True)
    assert [int(o["left"]) for o in out] == [0, 0]
    chunks = [e for e in log if e[0] == "chunk"]
    assert chunks == [("chunk", 0, 0, 64), ("chunk", 1, 0, 64),
                      ("chunk", 1, 1, 64), ("chunk", 1, 2, 64),
                      ("chunk", 1, 3, 5)]
    first_read_after = log.index(("chunk", 1, 0, 64)) + 1
    assert log[first_read_after][0] == "read"


# ---------------------------------------------------------------------------
# one shard is the unsharded run
# ---------------------------------------------------------------------------

KW = dict(seed=7, max_steps=256, device="cpu")


def test_mesh1_simulate_ctmc_bit_identical():
    p = small_params()
    assert_same(tv.simulate_ctmc(p, n_replicas=64, **KW),
                tv.simulate_ctmc(p, n_replicas=64, shards=1, **KW))


def test_mesh1_sweep_bit_identical():
    pts = [small_params(), small_params(spare_pool_size=8),
           small_params(random_failure_rate=0.001)]
    assert_same(tv.simulate_ctmc_sweep(pts, n_replicas=32, **KW),
                tv.simulate_ctmc_sweep(pts, n_replicas=32, shards=1, **KW))


def test_mesh1_via_params_knob():
    assert_same(tv.simulate_ctmc(small_params(), n_replicas=64, **KW),
                tv.simulate_ctmc(small_params(engine_shards=1),
                                 n_replicas=64, **KW))


def test_mesh1_multijob_bit_identical():
    cluster = Params(working_pool_size=64, spare_pool_size=8,
                     repair_servers=2)
    jobs = (JobSpec(job_size=16, job_length=400.0),
            JobSpec(job_size=24, job_length=300.0, warm_standbys=2))
    pts = [(cluster, jobs), (cluster.replace(spare_pool_size=4), jobs)]
    kw = dict(n_replicas=16, seed=5, max_steps=256, device="cpu")
    assert_same(tm.simulate_multijob_ctmc_sweep(pts, **kw),
                tm.simulate_multijob_ctmc_sweep(pts, shards=1, **kw))


# ---------------------------------------------------------------------------
# shard s is its independent run
# ---------------------------------------------------------------------------

#: name -> small_params overrides: exponential lanes only; a repair-slot
#: lane (B, n_slots) with float64 age and slots; shock lanes (B, D)
SHARD_CONFIGS = {
    "exponential": {},
    "weibull_repairs_age64": dict(
        failure_distribution="weibull", repair_distribution="weibull",
        distribution_kwargs={"k": 1.5}, age_dtype="float64",
        auto_repair_time=30.0, manual_repair_time=120.0),
    "fault_domains": dict(fault_domains=FaultTopology(
        n_racks=4, racks_per_pod=2, rack_shock_rate=2e-3,
        pod_shock_rate=6e-4)),
}


@pytest.mark.parametrize("config", list(SHARD_CONFIGS))
@pytest.mark.parametrize("n_shards", [2, 4])
def test_per_shard_independence_exact(n_shards, config, monkeypatch):
    """Every output lane of shard s, histograms and a ring that wraps
    included, and every lane of its final state, the float64 age and
    repair-slot lanes and the per-domain shock counts included, is the
    unsharded run over R / n replicas with the shard's seed."""
    finals = []
    loop = tv._chunk_loop

    def keep(*args, **kwargs):
        out = loop(*args, **kwargs)
        finals.append(tv.state_to_numpy(out))
        return out

    monkeypatch.setattr(tv, "_chunk_loop", keep)
    p = small_params(max_run_records=4, random_failure_rate=2e-3,
                     **SHARD_CONFIGS[config])
    R, kw = 64, dict(max_steps=512, device="cpu")
    sharded = tv.simulate_ctmc(p, n_replicas=R, seed=3, shards=n_shards,
                               **kw)
    assert (sharded["n_runs"] > 4).any()
    if p.age_dtype == "float64":
        assert finals[0]["age"].dtype == finals[0]["repair_rem"].dtype \
            == np.float64
        assert finals[0]["repair_rem"].shape[0] == R
        assert sharded["n_manual_repairs"].sum() > 0
    if p.fault_domains is not None:
        assert sharded["domain_shocks"].shape == (R, 6)
        assert sharded["n_domain_shocks"].sum() > 0
    R_loc = R // n_shards
    for s, seed in enumerate(rs.shard_seeds(3, n_shards)):
        rows = slice(s * R_loc, (s + 1) * R_loc)
        alone = tv.simulate_ctmc(p, n_replicas=R_loc, seed=seed, **kw)
        assert_same(rows_of(sharded, rows, R), alone, f"shard{s}")
        final = {k: v for k, v in finals[0].items() if k != "hist_edges"}
        assert_same(rows_of(final, rows, R),
                    {k: v for k, v in finals[-1].items()
                     if k != "hist_edges"}, f"shard{s} state")


def test_histogram_merge_exact():
    p = small_params()
    R, kw = 64, dict(max_steps=512, device="cpu")
    sharded = tv.simulate_ctmc(p, n_replicas=R, seed=11, shards=4, **kw)
    parts = [tv.simulate_ctmc(p, n_replicas=R // 4, seed=s, **kw)
             for s in rs.shard_seeds(11, 4)]
    hist_keys = [k for k in sharded if k.startswith("hist_")
                 and k != "hist_edges"]
    assert hist_keys
    for hk in hist_keys:
        merged = sharded[hk]
        assert np.array_equal(merged, np.concatenate([q[hk] for q in parts]))
        assert np.array_equal(merged.sum(0), sum(q[hk].sum(0)
                                                 for q in parts))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_padded_sweep_shards_are_their_runs(n_shards):
    """A 3-point sweep (padded to 4 points) at 32 replicas: shard s's
    replicas of every point are the 8- or 16-replica sweep with the shard's
    seed, and each point is its sharded single-point run."""
    pts = [small_params(), small_params(spare_pool_size=8),
           small_params(warm_standbys=2, checkpoint_interval=60.0)]
    R, kw = 32, dict(max_steps=256, device="cpu")
    sw = tv.simulate_ctmc_sweep(pts, n_replicas=R, seed=9, shards=n_shards,
                                **kw)
    R_loc = R // n_shards
    for s, seed in enumerate(rs.shard_seeds(9, n_shards)):
        alone = tv.simulate_ctmc_sweep(pts, n_replicas=R_loc, seed=seed,
                                       **kw)
        rows = slice(s * R_loc, (s + 1) * R_loc)
        for got, want in zip(sw, alone):
            assert_same(rows_of(got, rows, R), want, f"shard{s}")
    for p, got in zip(pts, sw):
        assert_same(got, tv.simulate_ctmc(p, n_replicas=R, seed=9,
                                          shards=n_shards, **kw))


@pytest.mark.parametrize("cluster", ["two", "four"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_multijob_shards_are_their_runs(cluster, n_shards):
    c, jobs = {"two": TWO_JOB, "four": FOUR_JOB}[cluster]
    pts = [(c, jobs), (c.replace(spare_pool_size=4), jobs)]
    R, kw = 8, dict(max_steps=128, device="cpu")
    sharded = tm.simulate_multijob_ctmc_sweep(pts, n_replicas=R, seed=5,
                                              shards=n_shards, **kw)
    R_loc = R // n_shards
    for s, seed in enumerate(rs.shard_seeds(5, n_shards)):
        alone = tm.simulate_multijob_ctmc_sweep(pts, n_replicas=R_loc,
                                                seed=seed, **kw)
        rows = slice(s * R_loc, (s + 1) * R_loc)
        for got, want in zip(sharded, alone):
            assert_same(rows_of(got, rows, R), want, f"shard{s}")
    assert all(res["conservation_err"].max() == 0.0 for res in sharded)


def test_backend_passes_the_knob():
    p = small_params(engine_shards=2)
    rep = tb.run_replications(p, 16, max_steps=256, device="cpu")
    want = tv.simulate_ctmc(small_params(), n_replicas=16, seed=p.seed,
                            max_steps=256, shards=2, device="cpu")
    assert_same(rep.arrays, want)
    [batch] = tb.run_replications_batch([p], 16, max_steps=256,
                                        device="cpu")
    assert_same(batch.arrays, want)
    c, jobs = TWO_JOB
    mj = tb.run_replications_multijob(c.replace(engine_shards=2), jobs, 4,
                                      max_steps=64, device="cpu")
    assert mj.engine == "ctmc"


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.fixture
def ref():
    pytest.importorskip("jax")
    from repro.core import vectorized as jv
    return jv


def _message(fn, *args, **kw):
    with pytest.raises(ValueError) as err:
        fn(*args, **kw)
    return str(err.value)


def test_non_divisible_replica_count_refused_as_the_reference(ref):
    from repro.core.params import Params as JParams
    mine = _message(tv.simulate_ctmc, small_params(), n_replicas=10, seed=0,
                    max_steps=64, shards=3, device="cpu")
    theirs = _message(ref.simulate_ctmc, JParams.from_dict(
        small_params().to_dict()), n_replicas=10, seed=0, max_steps=64,
        shards=3)
    assert "does not divide" in mine and mine == theirs
    # a bucketed sweep checks the run's replica count, a power of two
    with pytest.raises(ValueError, match="replica count 16"):
        tv.simulate_ctmc_sweep([small_params()], n_replicas=12, shards=3,
                               max_steps=64, device="cpu")


def test_mixed_engine_shards_grid_refused_as_the_reference(ref):
    from repro.core.params import Params as JParams
    pts = [small_params(engine_shards=0), small_params(engine_shards=1)]
    mine = _message(tv.simulate_ctmc_sweep, pts, n_replicas=32,
                    max_steps=64, device="cpu")
    theirs = _message(ref.simulate_ctmc_sweep,
                      [JParams.from_dict(p.to_dict()) for p in pts],
                      n_replicas=32, max_steps=64)
    assert "engine_shards" in mine and mine == theirs
    c, jobs = TWO_JOB
    with pytest.raises(ValueError, match="engine_shards"):
        tm.simulate_multijob_ctmc_sweep(
            [(c, jobs), (c.replace(engine_shards=2), jobs)], n_replicas=4,
            device="cpu")


def test_missing_cards_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match=r"needs 8 CUDA devices.* only 2 "):
        tv._shard_mesh(8, 64, torch.device("cuda"))
    # the divisibility check comes first, as in the reference
    with pytest.raises(ValueError, match="does not divide"):
        tv._shard_mesh(3, 64, torch.device("cuda"))


def test_bad_knob_values_refused():
    with pytest.raises(ValueError, match="engine_shards"):
        small_params(engine_shards=-1).validate()
    with pytest.raises(ValueError, match="event_race_impl"):
        small_params(event_race_impl="pallas").validate()
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        tv.simulate_ctmc(small_params(), n_replicas=8, max_steps=64,
                         shards=-1, device="cpu")


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_routing_is_the_references(ref, shards):
    from repro.core import backend as jb
    from repro.core.params import Params as JParams
    for kw in ({}, {"age_dtype": "float64"},
               {"failure_distribution": "weibull", "age_dtype": "float64"}):
        p = small_params(engine_shards=shards, **kw)
        j = JParams.from_dict(p.to_dict())
        for engine in ("auto", "ctmc", "event"):
            assert tb.resolve_engine(p, engine) \
                == jb.resolve_engine(j, engine)
        assert tv.port_reasons(p) == []
    c, jobs = TWO_JOB
    assert tm.port_reasons_multijob(c.replace(engine_shards=shards),
                                    jobs) == []


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.cuda.device_count()


@pytest.mark.gpu
@pytest.mark.parametrize("n_shards", [2, 4])
def test_two_cards_shards_are_their_runs(n_shards):
    """Shard s on cuda:s is its own run there, single-job (through the
    chunk kernel) and multi-job (through the multi-job chunk kernel)."""
    if _cards() < n_shards:
        pytest.skip(f"needs {n_shards} CUDA devices")
    from repro_torch.kernels import ctmc_chunk, mj_chunk
    p = small_params(max_run_records=4, random_failure_rate=2e-3)
    R, R_loc = 64, 64 // n_shards
    launches = ctmc_chunk.LAUNCHES
    sharded = tv.simulate_ctmc(p, n_replicas=R, seed=3, shards=n_shards,
                               max_steps=512, device="cuda")
    assert ctmc_chunk.LAUNCHES > launches
    c, jobs = TWO_JOB
    mj_launches = mj_chunk.LAUNCHES
    mj = tm.simulate_multijob_ctmc(c, jobs, n_replicas=R, seed=5,
                                   shards=n_shards, max_steps=256,
                                   device="cuda")
    assert mj_chunk.LAUNCHES > mj_launches
    for s, seed in enumerate(rs.shard_seeds(3, n_shards)):
        rows = slice(R_loc * s, R_loc * (s + 1))
        alone = tv.simulate_ctmc(p, n_replicas=R_loc, seed=seed,
                                 max_steps=512, device=f"cuda:{s}")
        assert_same(rows_of(sharded, rows, R), alone)
    for s, seed in enumerate(rs.shard_seeds(5, n_shards)):
        rows = slice(R_loc * s, R_loc * (s + 1))
        alone = tm.simulate_multijob_ctmc(c, jobs, n_replicas=R_loc,
                                          seed=seed, max_steps=256,
                                          device=f"cuda:{s}")
        assert_same(rows_of(mj, rows, R), alone)


@pytest.mark.gpu
def test_one_card_refuses_two_shards():
    if _cards() != 1:
        pytest.skip("needs exactly one CUDA device")
    with pytest.raises(ValueError, match=r"needs 2 CUDA devices.* only 1 "):
        tv.simulate_ctmc(small_params(engine_shards=2), n_replicas=64,
                         max_steps=64, device="cuda")
