"""Multi-job cluster simulation (paper assumption 6's extension point).

Counterpart of ``src/repro/core/multijob.py``, kept line for line (pure
Python and numpy) so that the same Params and seed give the same draws
in the same order, and bit-identical results, in both packages.

"Note that we assume there is only one AI job executing at any time in
the cluster. However, this can be easily modified in the simulator if
needed, e.g., to consider multiple concurrent AI jobs."  — §III-A(6)

This module does that modification: N jobs share one working pool, one
spare pool, and one repair shop.  Each job runs the same coordinator
state machine as the single-job simulator; contention appears exactly
where the paper predicts — replacement acquisition.  Pool hand-offs on
repair completion go to the *stalled* job that has waited longest
(FIFO), then to standby refills round-robin, then back to the pools.

Outputs: one RunResult per job plus cluster-level contention metrics.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .coordinator import Coordinator
from .engine import Environment
from .histograms import Histogram, HistogramSpec
from .metrics import RunResult, histograms_from_results
from .params import Params
from .pool import PoolManager
from .repair import RepairShop
from .scheduler import Scheduler
from .server import FailureSampler, Fleet, Server


@dataclass
class JobSpec:
    """Per-job overrides on top of the shared cluster Params."""
    job_size: int
    job_length: float
    warm_standbys: int = 16
    start_time: float = 0.0


@dataclass
class MultiJobResult:
    per_job: List[RunResult]
    makespan: float = 0.0               # last job completion
    stall_events: int = 0               # cross-job starvation hand-offs
    #: cluster-level counters that live on the *shared* repair shop, not
    #: on any one job: n_auto_repairs / n_manual_repairs /
    #: n_failed_repairs (and n_retired under retirement policies).
    #: Historically these were silently dropped — the shop wrote them to
    #: a RunResult nobody kept — so multi-job repair accounting summed
    #: to zero; the parity suite pins this merge.
    cluster: RunResult = field(default_factory=RunResult)
    #: submissions that found every repair-shop service slot busy
    #: (finite ``Params.repair_servers`` only; 0 with an unbounded shop)
    queue_events: int = 0

    @property
    def total_failures(self) -> int:
        return sum(r.n_failures for r in self.per_job)

    def per_job_histograms(self, spec: Optional[HistogramSpec],
                           ) -> List[Dict[str, Histogram]]:
        """Per-job distribution channels (run_duration/recovery/waiting).

        Each job's coordinator records its own per-run duration lists;
        binning them through the shared
        :class:`~repro_torch.core.histograms.HistogramSpec` layout gives the
        per-job channels the cross-engine parity suite compares bin by
        bin against the CTMC engine's per-job streaming accumulators.
        """
        return [histograms_from_results([r], spec) for r in self.per_job]


class Dispatcher:
    """Routes repaired servers among jobs: longest-stalled job first,
    then the owning job's standby refill, then the pools."""

    def __init__(self, pools: PoolManager):
        self.pools = pools
        self.schedulers: List[Scheduler] = []
        self.stall_handoffs = 0

    def register(self, sched: Scheduler) -> None:
        self.schedulers.append(sched)

    def on_server_return(self, server: Server) -> None:
        # 1. longest-stalled job anywhere
        stalled = [s for s in self.schedulers
                   if s._stall_event is not None
                   and not s._stall_event.triggered]
        if stalled:
            target = min(stalled, key=lambda s: s._stall_since)
            self.stall_handoffs += 1
            target._stall_server = server
            target._stall_event.succeed(server)
            return
        # 2. the job that owned this server refills standbys
        for sched in self.schedulers:
            if (sched.job_active and server.sid in sched.job_members
                    and len(sched.standbys) < sched.params.warm_standbys):
                from .server import ServerState
                server.state = ServerState.STANDBY
                sched.standbys.append(server)
                return
        # 3. origin pool
        for sched in self.schedulers:
            sched.job_members.discard(server.sid)
        self.pools.push(server)

    def on_server_retired(self, server: Server) -> None:
        for sched in self.schedulers:
            sched.job_members.discard(server.sid)
        self.pools.retire(server)


class MultiJobSimulation:
    """N concurrent jobs over one shared fleet."""

    def __init__(self, cluster: Params, jobs: List[JobSpec],
                 seed: Optional[int] = None):
        total_needed = sum(j.job_size + j.warm_standbys for j in jobs)
        if cluster.working_pool_size < total_needed:
            raise ValueError(
                f"working pool {cluster.working_pool_size} cannot host "
                f"{len(jobs)} jobs needing {total_needed}")
        cluster.validate()
        self.cluster = cluster
        self.jobs = jobs
        self.rng = np.random.default_rng(
            cluster.seed if seed is None else seed)
        self.env = Environment()
        self.fleet = Fleet(cluster, self.rng)
        self.pools = PoolManager(cluster, self.fleet)
        self.dispatcher = Dispatcher(self.pools)
        self.results: List[RunResult] = [RunResult() for _ in jobs]
        # one shared repair shop feeding the dispatcher; repair counters
        # go to a cluster-level RunResult merged at the end
        self.repair_metrics = RunResult()
        self.repair_shop = RepairShop(
            self.env, cluster, self.rng, self.repair_metrics,
            on_return=self.dispatcher.on_server_return,
            on_retire=self.dispatcher.on_server_retired)
        self.coordinators: List[Coordinator] = []
        for spec, metrics in zip(jobs, self.results):
            job_params = cluster.replace(job_size=spec.job_size,
                                         job_length=spec.job_length,
                                         warm_standbys=spec.warm_standbys)
            sched = Scheduler(self.env, job_params, self.pools, metrics)
            sched._stall_since = 0.0
            self.dispatcher.register(sched)
            sampler = FailureSampler(job_params, self.rng)
            self.coordinators.append(Coordinator(
                self.env, job_params, self.rng, metrics, sched,
                self.repair_shop, sampler))

    def _run_job(self, idx: int, spec: JobSpec):
        if spec.start_time > 0:
            yield self.env.timeout(spec.start_time)
        sched = self.coordinators[idx].scheduler
        orig_stall = sched._stall_until_available

        def tracked_stall():
            sched._stall_since = self.env.now
            return orig_stall()

        sched._stall_until_available = tracked_stall
        yield from self.coordinators[idx].run_job()

    def run(self) -> MultiJobResult:
        procs = [self.env.process(self._run_job(i, spec), name=f"job{i}")
                 for i, spec in enumerate(self.jobs)]
        for proc in procs:
            self.env.run_until_process(proc)
        # repair counters live on the shared shop (repair_metrics);
        # per-job results carry the failure/replacement/stall accounting
        makespan = max(r.total_time for r in self.results)
        out = MultiJobResult(per_job=self.results, makespan=makespan,
                             stall_events=self.dispatcher.stall_handoffs,
                             cluster=self.repair_metrics,
                             queue_events=self.repair_shop.n_queued_events)
        return out


def simulate_multijob(cluster: Params, jobs: List[JobSpec],
                      n_replications: int = 1,
                      base_seed: int = 0) -> List[MultiJobResult]:
    return [MultiJobSimulation(cluster, list(jobs),
                               seed=base_seed + 7919 * rep).run()
            for rep in range(n_replications)]
