"""The port's paper tables (``repro_torch.studies.paper_tables``) against
the reference's ``benchmarks/paper_tables.py``.

The reference module is reached through ``repro.core``, as
tests/test_paper_claims.py does: its grid (benchmarks/paper_tables.py:
58-70) and statistics (:45-55, :159-165) are written out here.  On the CPU
the port runs the plain step loop, so the statistical parity check runs a
reduced grid (recovery time {10, 30} x pools {4112, 4160}, 32 replicas,
2 days); the full-size tables run on the card (chip_smoke.py phase 24),
held to tests/data/torch_paper_reference.json, whose grid is checked here.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import params as tparams
from repro_torch.studies import paper_tables as pt

torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.core import MINUTES_PER_DAY as DAY  # noqa: E402
from repro.core.params import PAPER_TABLE1_RANGES  # noqa: E402
from repro.core.params import Params as JParams  # noqa: E402
from repro.core.vectorized import simulate_ctmc_sweep as j_sweep  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
REFERENCE_JSON = ROOT / "tests" / "data" / "torch_paper_reference.json"
#: the reference's CSV names, under its results/ folder
REFERENCE_CSVS = ("fig2a_recovery_time.csv", "fig2b_waiting_time.csv",
                  "table1_sensitivity.csv")
METRICS = ("total_time", "n_failures", "n_preemptions")


def _j_grid(param, values, pools, days=32):
    """benchmarks/paper_tables.py:58-70 on the reference's Params."""
    grid = []
    for v in values:
        for pool in pools:
            base = dict(job_length=days * DAY, working_pool_size=pool)
            if param == "systematic_failure_rate_multiplier":
                p = JParams(**base)
                p = p.replace(systematic_failure_rate=v * p.random_failure_rate)
            else:
                p = JParams(**base, **{param: v})
            grid.append((v, pool, p))
    return grid


def test_constants_match_the_reference():
    # benchmarks/paper_tables.py:34-36, 135-141, 144
    assert pt.POOL_SIZES == [4112, 4128, 4160, 4192]
    assert pt.POOL_SIZES == PAPER_TABLE1_RANGES["working_pool_size"]
    assert (pt.JOB_DAYS, pt.N_REPLICAS) == (32, 256)
    assert tparams.PAPER_TABLE1_RANGES == PAPER_TABLE1_RANGES
    assert pt.SENSITIVITY_PARAMS == [
        "random_failure_rate", "systematic_failure_rate_multiplier",
        "systematic_failure_fraction", "warm_standbys", "host_selection_time",
        "automated_repair_probability", "auto_repair_failure_probability",
        "manual_repair_failure_probability", "auto_repair_time",
        "manual_repair_time", "spare_pool_size", "diagnosis_probability"]
    sig = pt.sensitivity.__defaults__
    assert sig[:2] == (128, (4112, 4160))
    assert pt.RESULTS_DIR == str(Path("results") / "torch")


@pytest.mark.parametrize("param", ["recovery_time", "waiting_time",
                                   "systematic_failure_rate_multiplier"])
def test_grid_matches_the_reference(param):
    values = PAPER_TABLE1_RANGES[param]
    port = pt.two_way_grid(param, values)
    ref = _j_grid(param, values, PAPER_TABLE1_RANGES["working_pool_size"])
    assert [(v, pool) for v, pool, _ in port] == \
        [(v, pool) for v, pool, _ in ref]
    for (_, _, p), (_, _, q) in zip(port, ref):
        pd, qd = p.to_dict(), q.to_dict()
        assert set(qd) <= set(pd)
        assert {k: pd[k] for k in qd} == qd
        # the port's Params rebuilt from the reference's is the same point
        assert tparams.Params.from_dict(qd) == p


def test_cell_stats_and_effect_sizes_are_the_reference_formulas():
    rng = np.random.default_rng(3)
    n = 37
    out = {"total_time": rng.uniform(4e4, 5e4, n).astype(np.float32),
           "useful_work": rng.uniform(3e4, 4e4, n).astype(np.float32),
           "n_failures": rng.integers(0, 40, n).astype(np.int32),
           "n_preemptions": rng.integers(0, 9, n).astype(np.int32),
           "stall_time": rng.uniform(0, 90, n).astype(np.float32)}
    want = {
        "total_time_hours": float(out["total_time"].mean()) / 60.0,
        "total_time_ci95_hours": float(
            1.96 * out["total_time"].std() / np.sqrt(n)) / 60.0,
        "n_failures": float(out["n_failures"].mean()),
        "n_preemptions": float(out["n_preemptions"].mean()),
        "stall_hours": float(out["stall_time"].mean()) / 60.0,
        "overhead_fraction": float(
            1.0 - out["useful_work"].mean() / out["total_time"].mean())}
    assert pt._cell_stats(out, n) == want
    rows = [{"parameter": p, "total_time_hours": float(t)}
            for p, t in zip("aabbbc", rng.uniform(700, 900, 6))]
    want = {}
    for param in "abc":
        ts = [r["total_time_hours"] for r in rows if r["parameter"] == param]
        want[param] = (max(ts) - min(ts)) / min(ts)
    assert pt.effect_sizes(rows) == want
    assert want["c"] == 0.0


def test_reduced_grid_matches_the_reference(monkeypatch):
    """Recovery time {10, 30} x pools {4112, 4160} at 32 replicas and 2
    days, the port's two_way_sweep on the CPU against the reference's
    engine on the same grid: every row's mean within |z| < 3.5."""
    values, pools, n, days = [10.0, 30.0], [4112, 4160], 32, 2
    monkeypatch.setattr(pt, "JOB_DAYS", days)
    seen = []

    def spy(params_list, **kw):
        outs = sweep(params_list, **kw)
        seen.append((params_list, kw, outs))
        return outs

    sweep = pt.simulate_ctmc_sweep
    monkeypatch.setattr(pt, "simulate_ctmc_sweep", spy)
    rows = pt.two_way_sweep("recovery_time", values, pools, n, device="cpu")
    (port_pts, kw, outs), = seen
    assert kw == {"n_replicas": n, "seed": 0, "device": "cpu"}
    ref_grid = _j_grid("recovery_time", values, pools, days)
    ref = j_sweep([p for _, _, p in ref_grid], n_replicas=n, seed=0)
    assert len(rows) == len(ref) == len(outs) == 4
    for row, out, rout, (v, pool, _) in zip(rows, outs, ref, ref_grid):
        assert (row["recovery_time"], row["working_pool_size"]) == (v, pool)
        assert row == {"recovery_time": v, "working_pool_size": pool,
                       **pt._cell_stats(out, n)}
        assert bool(np.all(out["completed"]))
        for m in METRICS:
            a = np.asarray(out[m], np.float64)
            b = np.asarray(rout[m], np.float64)
            se = math.sqrt((a.std() ** 2 + b.std() ** 2) / n)
            z = (a.mean() - b.mean()) / max(se, 1e-9)
            assert abs(z) < 3.5, (v, pool, m, a.mean(), b.mean(), z)


def _fake_sweep(calls):
    """A stand-in engine call that records its grid and returns constant
    arrays of the engine's keys."""
    def fake(params_list, n_replicas, seed, device):
        calls.append((list(params_list), n_replicas, seed, device))
        one = np.ones(n_replicas, np.float32)
        return [{"total_time": 2 * one, "useful_work": one,
                 "n_failures": one, "n_preemptions": one,
                 "stall_time": one} for _ in params_list]
    return fake


def _reference_csvs():
    return {name: (ROOT / "results" / name).read_bytes()
            for name in REFERENCE_CSVS if (ROOT / "results" / name).exists()}


def test_results_dir_is_honoured(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(pt, "simulate_ctmc_sweep", _fake_sweep(calls))
    before = _reference_csvs()
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "tables"
    pt.fig2a(n_replicas=4, device="cpu", results_dir=str(out))
    pt.fig2b(n_replicas=4, device="cpu", results_dir=str(out))
    pt.sensitivity(n_replicas=4, device="cpu", results_dir=str(out))
    assert {p.name for p in out.glob("*.csv")} == set(REFERENCE_CSVS)
    # nothing went to the working directory's results/ folder, nor to the
    # reference's tables
    assert not (tmp_path / "results").exists()
    assert _reference_csvs() == before
    assert all(c[3] == "cpu" for c in calls)
    with open(out / "fig2a_recovery_time.csv") as f:
        assert f.readline().strip().split(",") == [
            "recovery_time", "working_pool_size", "total_time_hours",
            "total_time_ci95_hours", "n_failures", "n_preemptions",
            "stall_hours", "overhead_fraction"]
    with open(out / "table1_sensitivity.csv") as f:
        head = f.readline().strip().split(",")
        assert head[-2:] == ["parameter", "value"]
        assert sum(1 for _ in f) == 78


def test_reference_json_has_the_ports_grid(monkeypatch, tmp_path):
    """tests/data/torch_paper_reference.json holds exactly the grid that
    the port's fig2a, fig2b and sensitivity build, in their order."""
    calls = []
    monkeypatch.setattr(pt, "simulate_ctmc_sweep", _fake_sweep(calls))
    tables = [("fig2a", pt.fig2a, "recovery_time"),
              ("fig2b", pt.fig2b, "waiting_time"),
              ("sensitivity", pt.sensitivity, None)]
    want = []
    for table, fn, param in tables:
        first = len(calls)
        rows = fn(device="cpu", results_dir=str(tmp_path))
        pts = [(p, n, seed) for ps, n, seed, _ in calls[first:]
               for p in ps]
        assert len(pts) == len(rows)
        for row, (p, n, seed) in zip(rows, pts):
            name = param or row["parameter"]
            value = row[param] if param else row["value"]
            assert p.working_pool_size == row["working_pool_size"]
            want.append({"table": table, "param": name, "value": value,
                         "pool": row["working_pool_size"], "replicas": n,
                         "days": p.job_length / DAY, "seed": seed})
    blob = json.loads(REFERENCE_JSON.read_text())
    keys = ("table", "param", "value", "pool", "replicas", "days", "seed")
    got = [{k: r[k] for k in keys} for r in blob["rows"]]
    assert len(got) == 102
    assert got == want
    for r in blob["rows"]:
        for m in METRICS:
            assert r[m]["n"] == r["replicas"]
            assert math.isfinite(r[m]["mean"]) and r[m]["std"] >= 0
