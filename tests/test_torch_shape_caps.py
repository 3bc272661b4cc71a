"""Shapes past the card's standard chunk instances, on the port's CTMC
engines: the wide instances of ``csrc/ctmc_chunk.cu`` and the runtime-J
instance of ``csrc/mj_chunk.cu``.

The reference's CTMC engines take any empirical segment count, any
histogram width, a repair-slot lane up to the cluster's servers and any
job count.  The standard instances stage their edges and slots in shared
memory and unroll their job loops, so their wrappers refuse past those
caps (tests/test_torch_ctmc_chunk.py and tests/test_torch_mj_chunk.py pin
the refusals).  The engines route such a shape, before launch, to an
instance that takes it.

On the CPU: the wide layout takes 65 and 256 empirical failure segments,
65 empirical repair segments, 65,536 histogram edges and a 32,768-slot
lane in float32 and float64 age, with no shared memory, where the
standard layout refuses each; ``ctmc_chunk.wide_for`` routes exactly
those shapes; the runtime-J layout takes nine and sixteen jobs and puts a
row's words in global memory where 32 rows do not fit a block.  On the
card (marked ``gpu``): each of those configurations through
``simulate_ctmc`` / ``simulate_multijob_ctmc`` under the default ``impl``
launches only the named instance, a launch a chunk, and equals
``impl="ref"`` bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import hazards
from repro_torch.core import vectorized as tv
from repro_torch.core import vectorized_multijob as tm
from repro_torch.core.histograms import HistogramSpec
from repro_torch.core.multijob import JobSpec
from repro_torch.core.params import MINUTES_PER_DAY as DAY
from repro_torch.core.params import Params
from repro_torch.kernels import ctmc_chunk, mj_chunk

torch.set_num_threads(1)

BASE = Params(job_size=24, working_pool_size=32, spare_pool_size=4,
              warm_standbys=2, job_length=2 * DAY,
              random_failure_rate=2.0 / DAY,
              systematic_failure_rate=4.0 / DAY, recovery_time=5.0,
              auto_repair_time=30.0, manual_repair_time=120.0)


def _fit(n_seg: int) -> dict:
    """An empirical fit of ``n_seg`` segments: rising edges, rates that
    wander over a decade."""
    return {"edges": [0.05 * (i + 1) for i in range(n_seg - 1)],
            "rates": [0.3 + 1.2 * ((7 * i) % 11) / 10.0
                      for i in range(n_seg)]}


#: configuration -> Params past a standard instance's cap
CONFIGS = {
    "empirical_65_segments": BASE.replace(
        failure_distribution="empirical", distribution_kwargs=_fit(65)),
    "empirical_256_segments": BASE.replace(
        failure_distribution="empirical", distribution_kwargs=_fit(256)),
    "empirical_repair_65_segments": BASE.replace(
        repair_distribution="empirical", distribution_kwargs=_fit(65)),
    "weibull_slots_32768": Params(
        job_size=32768, working_pool_size=33024, spare_pool_size=256,
        warm_standbys=16, job_length=0.5 * DAY,
        repair_distribution="weibull", distribution_kwargs={"k": 0.7},
        repair_slots=32768),
    "weibull_slots_32768_age64": Params(
        job_size=32768, working_pool_size=33024, spare_pool_size=256,
        warm_standbys=16, job_length=0.5 * DAY,
        repair_distribution="weibull", distribution_kwargs={"k": 0.7},
        repair_slots=32768, age_dtype="float64"),
    "hist_65536_edges": BASE.replace(histogram=HistogramSpec(
        low=1e-2, high=1e7, n_bins=65535)),
}
NINE = tuple(JobSpec(4, 100.0 + 30.0 * j, j % 2) for j in range(9))
SIXTEEN = tuple(JobSpec(3, 150.0 + 20.0 * j, j % 3) for j in range(16))
LOCK = Params(working_pool_size=60, spare_pool_size=4, job_size=16,
              job_length=400.0, random_failure_rate=0.004,
              systematic_failure_rate=0.01, auto_repair_time=150.0,
              manual_repair_time=400.0, repair_servers=3,
              diagnosis_uncertainty=0.2)


def _chunk_inputs(p: Params, R: int = 2):
    """The engine's initial state, one chunk's draw and the parameter row
    of ``p`` at R replicas, on the CPU, with the family's keywords."""
    kind = hazards.hazard_kind(p)
    rkind = hazards.repair_kind(p) or "exponential"
    fam = dict(kind=kind, n_seg=hazards.hazard_segment_count(p),
               rkind=rkind, n_rseg=hazards.repair_segment_count(p))
    state = tv._initial_state_batch([p], R, 4, "cpu", rkind,
                                    tv._repair_slots_for([p], rkind))
    us = torch.rand((4, R, ctmc_chunk.n_uniforms(kind, rkind)))
    pv = torch.as_tensor(tv._params_vector(p))
    return state, us, pv, tv._hist_channels([p]), fam


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_wide_layout_takes_what_the_standard_refuses(name):
    state, us, pv, channels, fam = _chunk_inputs(CONFIGS[name])
    assert ctmc_chunk.wide_for(state, fam["n_seg"], fam["n_rseg"])
    with pytest.raises(ValueError, match="ctmc_chunk: "):
        ctmc_chunk.chunk_layout(state, us, pv, 2, 1, channels, **fam)
    layout = ctmc_chunk.chunk_layout(state, us, pv, 2, 1, channels,
                                     wide=True, **fam)
    assert layout["wide"]
    assert layout["age64"] == (state["age"].dtype == torch.float64)
    if "repair_rem" in state:
        assert layout["n_slots"] == state["repair_rem"].shape[1]
        assert layout["plan"] == {"threads": 32, "smem_bytes": 0}
    if name == "hist_65536_edges":
        assert layout["n_edges"] == 65536
    if name.startswith("weibull_slots"):
        assert layout["n_slots"] == 32768


@pytest.mark.parametrize("overrides", [
    {}, dict(failure_distribution="empirical", distribution_kwargs=_fit(64)),
    dict(repair_distribution="empirical", distribution_kwargs=_fit(64)),
    dict(repair_distribution="weibull", distribution_kwargs={"k": 0.7},
         working_pool_size=20000, repair_slots=16384),
    dict(histogram=HistogramSpec(low=1e-2, high=1e7, n_bins=32767))],
    ids=["exponential", "empirical_64", "repair_64", "slots_16384",
         "edges_32768"])
def test_standard_shapes_stay_standard(overrides):
    state, us, pv, channels, fam = _chunk_inputs(BASE.replace(**overrides))
    assert not ctmc_chunk.wide_for(state, fam["n_seg"], fam["n_rseg"])
    layout = ctmc_chunk.chunk_layout(state, us, pv, 2, 1, channels, **fam)
    assert not layout["wide"]


@pytest.mark.parametrize("jobs", [NINE, SIXTEEN], ids=["J9", "J16"])
def test_runtime_j_layout_takes_the_jobs(jobs):
    J, R = len(jobs), 4
    cluster = LOCK.replace(working_pool_size=80)
    state = tm._mj_initial_state_batch([(cluster, jobs)], R, 4, "cpu")
    us = torch.rand((4, R, mj_chunk.N_UNIFORMS))
    pv = torch.as_tensor(tm._mj_params_vector(cluster, jobs))
    channels = tv._selected_channels(cluster.histogram)
    assert mj_chunk.runtime_for(J) and not mj_chunk.runtime_for(8)
    with pytest.raises(ValueError, match="takes 1..8 jobs a cluster"):
        mj_chunk.mj_chunk_layout(state, us, pv, R, 1, J, channels)
    layout = mj_chunk.mj_chunk_layout(state, us, pv, R, 1, J, channels,
                                      runtime=True)
    assert layout["runtime"] and layout["J"] == J
    assert layout["rows"] in (32, 64, 128)
    assert not layout["global_words"]


def test_runtime_j_words_go_global_past_a_block():
    assert mj_chunk.rt_plan(9, 130) == {"rows": 128, "global_words": False}
    assert mj_chunk.rt_plan(38, 130)["global_words"] is False
    assert mj_chunk.rt_plan(40, 130) == {"rows": 128, "global_words": True}
    with pytest.raises(ValueError, match="histogram edges"):
        mj_chunk.rt_plan(9, 60000)


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        if k == "per_job":
            for da, db in zip(a[k], b[k]):
                for m in db:
                    np.testing.assert_array_equal(da[m], db[m], err_msg=m)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cuda_wide_instance_matches_plain(name):
    _needs_cuda()
    p = CONFIGS[name]
    R = 16 if name.startswith("weibull_slots") else 64
    launches, wide = ctmc_chunk.LAUNCHES, ctmc_chunk.LAUNCHES_WIDE
    got = tv.simulate_ctmc(p, R, seed=3, max_steps=192, early_exit=False,
                           device="cuda")
    assert ctmc_chunk.LAUNCHES - launches == 3
    assert ctmc_chunk.LAUNCHES_WIDE - wide == 3
    want = tv.simulate_ctmc(p, R, seed=3, max_steps=192, early_exit=False,
                            impl="ref", device="cuda")
    assert ctmc_chunk.LAUNCHES - launches == 3
    _equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("jobs", [NINE, SIXTEEN], ids=["J9", "J16"])
def test_cuda_runtime_j_matches_plain(jobs):
    _needs_cuda()
    cluster = LOCK.replace(working_pool_size=80)
    launches, rt = mj_chunk.LAUNCHES, mj_chunk.LAUNCHES_RT
    got = tm.simulate_multijob_ctmc(cluster, jobs, n_replicas=64,
                                    max_steps=192, early_exit=False,
                                    device="cuda")
    assert mj_chunk.LAUNCHES - launches == mj_chunk.LAUNCHES_RT - rt == 3
    want = tm.simulate_multijob_ctmc(cluster, jobs, n_replicas=64,
                                     max_steps=192, early_exit=False,
                                     impl="ref", device="cuda")
    _equal(got, want)
