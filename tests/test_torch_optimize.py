"""The port's checkpoint optimizer, on the CPU.

``default_interval_bounds`` equals the reference's on every config.  The
reference's optimizer checks (``tests/test_checkpoint_opt.py``) hold
inside the port: the result lies within one grid notch of Young/Daly, the
golden-section bracket contracts by exactly 1/phi an iteration, the
evaluation count is the grid plus two a refinement, and a fixed seed gives
the same search twice -- the port's chunk draws depend on ``(seed, chunk
index)`` only, so the objective is deterministic across the 12-point grid
and the 2-point refinements.  Only guaranteed properties are asserted;
the reference's statistical orderings are not copied.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import optimize as topt
from repro_torch.core.analytical import (cluster_failure_rate,
                                         young_daly_interval)
from repro_torch.core.params import Params as TParams

torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.core import optimize as jopt  # noqa: E402
from repro.core.params import MINUTES_PER_DAY as DAY  # noqa: E402
from repro.core.params import Params as JParams  # noqa: E402

#: tests/test_checkpoint_opt.py's rollback-heavy config
BASE = TParams(job_size=16, working_pool_size=20, spare_pool_size=4,
               warm_standbys=2, job_length=4 * DAY,
               random_failure_rate=0.2 / DAY, seed=3,
               checkpoint_interval=113.0, checkpoint_cost=5.0)


@pytest.mark.parametrize("kw", [
    {}, {"random_failure_rate": 0.0, "systematic_failure_rate": 0.0},
    {"checkpoint_cost": 0.0}, {"checkpoint_cost": 2000.0},
    {"job_length": 30.0}, {"job_size": 4096, "working_pool_size": 4160,
                           "spare_pool_size": 200}])
def test_default_interval_bounds_match_reference(kw):
    port = BASE.replace(**kw)
    ref = JParams.from_dict(port.to_dict())
    assert topt.default_interval_bounds(port) == \
        jopt.default_interval_bounds(ref)


def test_default_interval_bounds_bracket_young_daly():
    lo, hi = topt.default_interval_bounds(BASE)
    yd = young_daly_interval(BASE.checkpoint_cost,
                             1.0 / cluster_failure_rate(BASE))
    assert lo < yd < hi and lo >= BASE.checkpoint_cost
    lo0, hi0 = topt.default_interval_bounds(
        BASE.replace(random_failure_rate=0.0))
    assert 0 < lo0 < hi0 <= BASE.job_length


def test_optimizer_lands_within_one_notch_of_young_daly():
    yd = young_daly_interval(BASE.checkpoint_cost,
                             1.0 / cluster_failure_rate(BASE))
    res = topt.optimize_checkpoint_interval(BASE, n_replicas=256, n_grid=12,
                                            refine_iters=8, device="cpu")
    assert res.young_daly == pytest.approx(yd)
    grid = np.array(res.grid)
    notch = (grid[1] / grid[0]) ** 1.5   # one notch + golden-section slack
    assert yd / notch <= res.interval <= yd * notch, (res.interval, yd)
    best = int(np.argmax(res.grid_objective))
    assert 0 < best < len(grid) - 1
    assert res.objective >= max(res.grid_objective)
    assert res.n_evals == 12 + 2 * len(res.history)


def test_golden_section_contracts_and_is_deterministic():
    kw = dict(n_replicas=64, n_grid=8, refine_iters=6, device="cpu")
    res = topt.optimize_checkpoint_interval(BASE, **kw)
    assert res.history, "refinement must record its bracket"
    widths = [b - a for a, b in res.history]
    for w0, w1 in zip(widths, widths[1:]):
        assert w1 < w0
        assert w1 == pytest.approx(w0 * (math.sqrt(5) - 1) / 2, rel=1e-6)
    assert res.n_evals == 8 + 2 * len(res.history)
    again = topt.optimize_checkpoint_interval(BASE, **kw)
    assert again == res


def test_optimize_knobs_coordinate_descent():
    axes = {"checkpoint_interval": (40.0, 160.0), "warm_standbys": (0, 2)}
    res = topt.optimize_knobs(BASE.replace(job_length=1 * DAY), axes,
                              n_replicas=16, engine="ctmc", max_sweeps=2,
                              device="cpu")
    assert set(res.values) == set(axes)
    assert res.n_evals >= sum(len(v) for v in axes.values())
    assert res.history and res.objective > 0
    last = {name: (cand, vals) for name, cand, vals in res.history}
    for name, (cand, vals) in last.items():
        assert res.values[name] == cand[int(np.argmax(vals))]
    with pytest.raises(ValueError):
        topt.optimize_knobs(BASE, {})
    with pytest.raises(ValueError):
        topt.optimize_knobs(BASE, {"not_a_field": (1, 2)})


def test_optimizer_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        topt.optimize_checkpoint_interval(BASE, n_replicas=4, n_grid=3,
                                          refine_iters=0)
