"""Top-level ClusterSimulation: wires the five AIReSim modules together.

Counterpart of ``src/repro/core/simulation.py``, kept line for line (pure
Python and numpy) so that the same Params and seed give the same draws
in the same order, and bit-identical results, in both packages.

One ClusterSimulation = one replication: it builds the fleet, pools,
scheduler, repair shop, and coordinator on a fresh DES environment and
runs the job to completion, returning a :class:`RunResult`.

``simulate(params, n_replications)`` is the main entry point used by
sweeps, benchmarks, and tests.
"""

from __future__ import annotations

from typing import Generator, List, Optional

import numpy as np

from .coordinator import Coordinator
from .engine import Environment
from .faultdomains import ShockInjector
from .metrics import RunResult
from .params import Params
from .pool import PoolManager
from .repair import RepairShop
from .scheduler import Scheduler
from .server import FailureSampler, Fleet


class ClusterSimulation:
    def __init__(self, params: Params, seed: Optional[int] = None):
        params.validate()
        self.params = params
        self.rng = np.random.default_rng(
            params.seed if seed is None else seed)
        self.env = Environment()
        self.metrics = RunResult()
        self.fleet = Fleet(params, self.rng)
        self.pools = PoolManager(params, self.fleet)
        self.scheduler = Scheduler(self.env, params, self.pools, self.metrics)
        self.repair_shop = RepairShop(
            self.env, params, self.rng, self.metrics,
            on_return=self.scheduler.on_server_return,
            on_retire=self.scheduler.on_server_retired)
        self.sampler = FailureSampler(params, self.rng)
        self.coordinator = Coordinator(
            self.env, params, self.rng, self.metrics, self.scheduler,
            self.repair_shop, self.sampler)
        # correlated failure domains / scripted campaigns (faultdomains):
        # one merged injection stream the coordinator races against
        # compute.  Zero shock rates and an empty campaign draw nothing
        # from the RNG, keeping plain runs bit-identical.
        self.injector = None
        if params.fault_domains is not None or params.campaign is not None:
            total = params.working_pool_size + params.spare_pool_size
            self.injector = ShockInjector(
                params.fault_domains, params.campaign, total, self.rng)
            self.coordinator.injector = self.injector
            # scenario return semantics: repaired servers backfill the
            # job's standbys regardless of membership (matches the CTMC
            # return lane, which carries no membership information)
            self.scheduler.standby_refill_any = True
            if params.fault_domains is not None:
                self.metrics.domain_shocks = (
                    [0] * params.fault_domains.n_domains)

    # -- bad-set regeneration (assumption 1, case 2) -------------------------
    def _regeneration_process(self) -> Generator:
        period = self.params.bad_set_regeneration_period
        while True:
            yield self.env.timeout(period)
            self.fleet.regenerate_bad_set()
            self.coordinator.rebuild_running_partition()

    # -- run -----------------------------------------------------------------
    def run(self) -> RunResult:
        if self.params.bad_set_regeneration_period > 0:
            self.env.process(self._regeneration_process(), name="regen")
        if self.injector is not None:
            # created before the job so a same-instant tie resolves
            # injection-first (the CTMC campaign-residual tie-break)
            self.env.process(self.coordinator.injection_loop(),
                             name="injector")
        job = self.env.process(self.coordinator.run_job(), name="job")
        self.coordinator._job_proc = job
        self.env.run_until_process(job)
        self.metrics.total_time = self.env.now
        return self.metrics


def simulate(params: Params, n_replications: int = 1,
             base_seed: Optional[int] = None) -> List[RunResult]:
    """Run independent replications (distinct substreams of ``base_seed``)."""
    base = params.seed if base_seed is None else base_seed
    results = []
    for rep in range(n_replications):
        sim = ClusterSimulation(params, seed=base + 7919 * rep)
        results.append(sim.run())
    return results


def simulate_one(params: Params, seed: Optional[int] = None) -> RunResult:
    return ClusterSimulation(params, seed=seed).run()
