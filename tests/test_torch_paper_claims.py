"""The paper's own experimental claims (§IV) on the port, on the card.

Counterpart of tests/test_paper_claims.py, with its names, sizes (N 160,
16 days, seed 0) and assertions, run through the port's
``simulate_ctmc`` on the card (the chunk kernel's exponential instance).
Claims checked:
  1. Fig 2a: total training time increases monotonically with recovery
     time, at every working-pool size.
  2. Fig 2b: total training time increases with spare-pool waiting time,
     and the effect is strongest at the smallest pool.
  3. Capacity finding: pools beyond +32 servers over job+standbys give
     no significant further improvement (<1%) at Table-I rates.
  4. Flat-knob finding: repair-pipeline knobs have <5% effect in the
     over-provisioned regime.

Each case is marked ``gpu`` (and ``slow``, as the reference's) and skips
without a card: ``python -m pytest -m gpu tests/test_torch_paper_claims.py``.
chip_smoke.py phase 24 asserts the same claims on the full-size tables.
"""

import pytest
import torch

from repro_torch.core import MINUTES_PER_DAY, Params
from repro_torch.core.vectorized import simulate_ctmc

N = 160
JOB_DAYS = 16


@pytest.fixture(autouse=True)
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def cell(pool: int, n=N, **kw) -> float:
    p = Params(job_length=JOB_DAYS * MINUTES_PER_DAY,
               working_pool_size=pool, **kw)
    out = simulate_ctmc(p, n_replicas=n, seed=0, device="cuda")
    return float(out["total_time"].mean())


@pytest.mark.gpu
@pytest.mark.slow
def test_fig2a_recovery_time_monotone():
    for pool in (4112, 4160):
        times = [cell(pool, recovery_time=rt) for rt in (10.0, 20.0, 30.0)]
        assert times[0] < times[1] < times[2], (pool, times)


@pytest.mark.gpu
@pytest.mark.slow
def test_fig2a_magnitude_matches_renewal_math():
    """Doubling recovery time adds ~E[failures]*delta to total time."""
    t10 = cell(4160, recovery_time=10.0)
    t30 = cell(4160, recovery_time=30.0)
    p = Params(job_length=JOB_DAYS * MINUTES_PER_DAY)
    expected_delta = p.expected_failures_per_minute() * p.job_length * 20.0
    assert t30 - t10 == pytest.approx(expected_delta, rel=0.35)


@pytest.mark.gpu
@pytest.mark.slow
def test_fig2b_waiting_time_hurts_small_pools_most():
    # zero-headroom pool: every post-standby failure must preempt
    tight_10 = cell(4112, waiting_time=10.0, warm_standbys=16)
    tight_30 = cell(4112, waiting_time=30.0, warm_standbys=16)
    big_10 = cell(4192, waiting_time=10.0, warm_standbys=16)
    big_30 = cell(4192, waiting_time=30.0, warm_standbys=16)
    assert tight_30 >= tight_10 - 1e-6
    # effect in the big pool is no larger than in the tight pool
    assert (big_30 - big_10) <= (tight_30 - tight_10) + 30.0


@pytest.mark.gpu
@pytest.mark.slow
def test_capacity_saturates_by_plus_32():
    t128 = cell(4128)
    t160 = cell(4160)
    t192 = cell(4192)
    assert abs(t192 - t160) / t160 < 0.01
    assert t128 >= t160 - 0.01 * t160


@pytest.mark.gpu
@pytest.mark.slow
def test_flat_knobs_in_overprovisioned_regime():
    base = cell(4160)
    variants = {
        "auto_repair_time": [(("auto_repair_time", v),) for v in (60., 180.)],
        "manual_repair_failure": [(("manual_repair_failure_probability", v),)
                                  for v in (0.1, 0.3)],
        "diagnosis": [(("diagnosis_probability", v),) for v in (0.6, 1.0)],
    }
    for name, settings_list in variants.items():
        for settings in settings_list:
            t = cell(4160, **dict(settings))
            assert abs(t - base) / base < 0.05, (name, settings, t, base)
