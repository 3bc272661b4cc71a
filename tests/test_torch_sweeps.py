"""Sweeps of the PyTorch port against the JAX reference's sweeps.

A port ``OneWaySweep(device="cpu")`` writes the reference's CSV columns,
and its means agree with the reference's in pooled-SE units (z < 3.5).
"""

import csv
import json

import numpy as np
import pytest
import torch

from repro_torch.core import sweeps as ts
from repro_torch.core.params import Params as TParams

torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.core import sweeps as js  # noqa: E402
from repro.core.params import MINUTES_PER_DAY as DAY  # noqa: E402
from repro.core.params import Params as JParams  # noqa: E402

BASE = JParams(job_size=32, working_pool_size=36, spare_pool_size=4,
               warm_standbys=2, job_length=1 * DAY,
               random_failure_rate=1.5 / DAY)
N = 384


def _header(path):
    with open(path, newline="") as f:
        return next(csv.reader(f))


def test_one_way_sweep_matches_reference(tmp_path):
    kw = dict(n_replications=N, base_seed=0)
    ref = js.OneWaySweep("ws", "warm_standbys", [0, 2, 4],
                         base_params=BASE, **kw).run()
    port = ts.OneWaySweep("ws", "warm_standbys", [0, 2, 4],
                          base_params=TParams.from_dict(BASE.to_dict()),
                          device="cpu", **kw).run()
    ref.write_csv(str(tmp_path / "ref.csv"))
    port.write_csv(str(tmp_path / "port.csv"))
    assert _header(tmp_path / "port.csv") == _header(tmp_path / "ref.csv")
    assert [p.engine for p in port.points] == ["ctmc"] * 3
    for pr, pp in zip(ref.points, port.points):
        assert pp.values == pr.values and pp.n_replications == N
        assert set(pp.stats) == set(pr.stats)
        for m in ts.DEFAULT_STATS:
            a, b = pr.stats[m], pp.stats[m]
            se = np.sqrt((a.std ** 2 + b.std ** 2) / N)
            z = (a.mean - b.mean) / max(se, 1e-9)
            assert abs(z) < 3.5, (pr.values, m, a.mean, b.mean, z)


def test_two_way_sweep_grid_order_and_json(tmp_path):
    calm = TParams(job_size=2, working_pool_size=3, spare_pool_size=1,
                   warm_standbys=0, job_length=10.0,
                   random_failure_rate=0.0, systematic_failure_rate=0.0,
                   histogram=None)
    seen = []
    res = ts.TwoWaySweep("demo", "job_length", [10.0, 20.0],
                         "host_selection_time", [0.0, 5.0],
                         n_replications=3, base_params=calm,
                         device="cpu").run(progress=seen.append)
    assert len(seen) == 4
    assert [(p.values["job_length"], p.values["host_selection_time"],
             p.stats["total_time"].mean) for p in res.points] == \
        [(10.0, 0.0, 10.0), (10.0, 5.0, 15.0), (20.0, 0.0, 20.0),
         (20.0, 5.0, 25.0)]
    res.write_json(str(tmp_path / "r.json"))
    data = json.loads((tmp_path / "r.json").read_text())
    assert data["parameters"] == ["job_length", "host_selection_time"]
    assert len(data["rows"]) == 4
    assert res.column("total_time") == [10.0, 15.0, 20.0, 25.0]


def test_virtual_multiplier_parameter():
    p = ts._apply_param(TParams(), "systematic_failure_rate_multiplier", 3)
    assert p.systematic_failure_rate == 3 * p.random_failure_rate
    assert ts._apply_param(TParams(), "warm_standbys", 8.0).warm_standbys == 8
    with pytest.raises(ValueError, match="unknown parameter"):
        ts._apply_param(TParams(), "nope", 1)
