"""Coordinator module: the job-execution loop and failure broadcast.

Counterpart of ``src/repro/core/coordinator.py``, kept line for line (pure
Python and numpy) so that the same Params and seed give the same draws
in the same order, and bit-identical results, in both packages.

Paper §III-C module (2): "Coordinator: ... When a server fails, the
coordinator is notified. In turn, it informs the other servers in the group
of the failure, and asks them to stop executing the job (and initiate a
fast recovery)."

In the analytical-failure formulation (see server.py), "informing all other
servers" is the act of ending the current compute phase: all failure clocks
stop, progress since the phase start is banked (minus optional checkpoint
rollback loss), the failed server is diagnosed and dispatched to repair, a
replacement is acquired through the Scheduler waterfall, the recovery cost
is paid, and a fresh phase begins (restarting every failure clock — the
paper's "failure process starts when a job is started on a server").
"""

from __future__ import annotations

import math
from typing import Generator, List, Optional

import numpy as np

from .engine import Environment, Interrupt
from .faultdomains import Injection, ShockInjector
from .metrics import RunResult
from .params import Params
from .repair import RepairShop
from .scheduler import Scheduler
from .server import FailureSampler, Server, ServerState


class Coordinator:
    def __init__(self, env: Environment, params: Params,
                 rng: np.random.Generator, metrics: RunResult,
                 scheduler: Scheduler, repair_shop: RepairShop,
                 sampler: FailureSampler):
        self.env = env
        self.params = params
        self.rng = rng
        self.metrics = metrics
        self.scheduler = scheduler
        self.repair_shop = repair_shop
        self.sampler = sampler
        # running servers partitioned by health class for O(1) sampling;
        # _pos maps sid -> (insertion-time bad flag, index) for swap-remove
        self.running_good: List[Server] = []
        self.running_bad: List[Server] = []
        self._pos: dict = {}
        self.remaining_work: float = params.job_length
        #: fault-domain injection stream (set by ClusterSimulation when
        #: Params.fault_domains / Params.campaign are configured)
        self.injector: Optional[ShockInjector] = None
        self._job_proc = None           # Process handle for interrupts
        self._deficit = 0               # running servers owed after shocks
        self._stalling = False          # inside the group-stall loop
        self._pending_shock_wait = 0.0  # planned post-shock restart wait

    # -- helpers -------------------------------------------------------------
    def _add_running(self, server: Server) -> None:
        lst = self.running_bad if server.is_bad else self.running_good
        self._pos[server.sid] = (server.is_bad, len(lst))
        lst.append(server)

    def _remove_running(self, server: Server) -> None:
        flag, idx = self._pos.pop(server.sid)
        lst = self.running_bad if flag else self.running_good
        last = lst.pop()
        if last is not server:
            lst[idx] = last
            self._pos[last.sid] = (flag, idx)

    def rebuild_running_partition(self) -> None:
        """Called after a bad-set regeneration re-flags servers."""
        servers = self.running_good + self.running_bad
        self.running_good = []
        self.running_bad = []
        self._pos.clear()
        for s in servers:
            self._add_running(s)

    def _diagnose(self, failed: Server) -> Optional[Server]:
        """Return the server to send to repair (None = undiagnosed)."""
        p = self.params
        if self.rng.random() >= p.diagnosis_probability:
            self.metrics.n_undiagnosed += 1
            return None
        if p.diagnosis_uncertainty > 0 and self.rng.random() < p.diagnosis_uncertainty:
            # wrong server fingered: a random *other* running server
            pool = self.running_good + self.running_bad
            others = [s for s in pool if s is not failed]
            if others:
                self.metrics.n_misdiagnosed += 1
                return others[int(self.rng.integers(len(others)))]
        return failed

    def _bank_progress(self, compute: float, ckpt_work: float) -> None:
        """Credit the ended phase's compute, minus checkpoint rollback.

        ``compute`` is the phase's total useful-compute time (the run
        record, gross of rollback, excluding checkpoint-write wall time);
        ``ckpt_work`` is the part past the last durable checkpoint, which
        is what a failure rolls back.  ``checkpoint_interval == 0`` keeps
        the historical model where nothing is ever lost.
        """
        p = self.params
        lost = ckpt_work if p.checkpoint_interval > 0 else 0.0
        self.metrics.lost_work += lost
        self.remaining_work -= (compute - lost)
        self.metrics.useful_work += (compute - lost)
        self.metrics.run_durations.append(compute)

    # -- the job ------------------------------------------------------------------
    def run_job(self) -> Generator:
        if self.injector is not None:
            return (yield from self._run_job_injected())
        p, m, env = self.params, self.metrics, self.env

        running = yield from self.scheduler.initial_allocation()
        for server in running:
            self._add_running(server)

        while self.remaining_work > 1e-9:
            if env.now >= p.max_sim_time:
                m.timed_out = True
                break
            if p.standbys_can_fail and self.scheduler.standbys:
                standby_good = [s for s in self.scheduler.standbys if not s.is_bad]
                standby_bad = [s for s in self.scheduler.standbys if s.is_bad]
                ttf, failed, is_systematic = self.sampler.sample_first_failure(
                    self.running_good + standby_good,
                    self.running_bad + standby_bad)
            else:
                ttf, failed, is_systematic = self.sampler.sample_first_failure(
                    self.running_good, self.running_bad)

            # ---- checkpoint segment loop ---------------------------------
            # the phase runs in segments bounded by the next checkpoint
            # write; the failure clock (``ttf``) is consumed by compute
            # time only — it is frozen, not restarted, while a paid write
            # runs.  Tie order matches the CTMC residual race: completion
            # beats a same-instant write (no final write on a finished
            # job) and a failure beats a same-instant write.
            compute = 0.0            # phase compute (the run record)
            ckpt_work = 0.0          # compute since the last durable write
            left = self.remaining_work
            completed = False
            while True:
                to_ckpt = (p.checkpoint_interval - ckpt_work
                           if p.checkpoint_interval > 0 else math.inf)
                if left <= ttf and left <= to_ckpt:
                    yield env.timeout(left)
                    compute += left
                    m.run_durations.append(compute)
                    m.useful_work += compute
                    self.remaining_work = 0.0
                    completed = True
                    break
                if ttf <= to_ckpt:
                    yield env.timeout(ttf)
                    compute += ttf
                    ckpt_work += ttf
                    break
                # checkpoint write: the checkpoint is durable from write
                # start; the write cost is pure wall-clock overhead
                yield env.timeout(to_ckpt)
                compute += to_ckpt
                left -= to_ckpt
                ttf -= to_ckpt
                ckpt_work = 0.0
                if p.checkpoint_cost > 0:
                    yield env.timeout(p.checkpoint_cost)
                    m.checkpoint_overhead += p.checkpoint_cost
            if completed:
                break

            # ---- failure: coordinator stops the group --------------------
            m.n_failures += 1
            if is_systematic:
                m.n_systematic_failures += 1
            else:
                m.n_random_failures += 1
            assert failed is not None
            failed.record_failure(env.now, is_systematic)
            self._bank_progress(compute, ckpt_work)

            # a failed standby (standbys_can_fail) just leaves the standby
            # list; the job itself does not restart
            if failed.state is ServerState.STANDBY:
                self.scheduler.standbys.remove(failed)
                self.repair_shop.submit(failed)
                continue

            # downtime clock for the recovery/waiting distribution
            # channels: failure instant -> compute restart (ETTR), with
            # the replacement-acquisition part recorded separately
            t_fail = env.now
            target = self._diagnose(failed)
            if target is not None:
                self._remove_running(target)
                self.repair_shop.submit(target)
                replacement = yield from self.scheduler.acquire_replacement()
                self._add_running(replacement)
            m.waiting_durations.append(env.now - t_fail)

            # checkpoint reload + restart
            yield env.timeout(p.recovery_time)
            m.recovery_overhead += p.recovery_time
            m.recovery_durations.append(env.now - t_fail)

        m.total_time = env.now
        self.scheduler.release_all(self.running_good + self.running_bad)
        self.running_good.clear()
        self.running_bad.clear()
        return m

    # -- fault-domain injections (see repro_torch.core.faultdomains) ----------------
    def injection_loop(self) -> Generator:
        """Drive the merged shock/campaign stream as its own process.

        Fires each injection at its exact time; injections that kill
        running servers interrupt the job process (unless it is already
        group-stalled, where growing the deficit is all that's needed).
        Created *before* the job process so a same-instant tie resolves
        injection-first, matching the CTMC race where the campaign
        residual is the first deterministic column.
        """
        assert self.injector is not None
        while True:
            t_next = self.injector.peek()
            if not math.isfinite(t_next) or t_next >= self.params.max_sim_time:
                return
            yield self.env.timeout(max(t_next - self.env.now, 0.0))
            self._apply_injection(self.injector.pop())

    def _apply_injection(self, inj: Injection) -> None:
        """Zero-time bookkeeping for one injection.

        Kills are resolved per compartment exactly as the CTMC step
        resolves them in expectation: free/standby victims go straight
        to repair, in-shop victims re-break, running victims trigger a
        group restart whose replacements are drawn immediately (the
        restart *wait* is charged by the job process afterwards).
        """
        p, m = self.params, self.metrics
        if inj.kind == "maint_start":
            self.repair_shop.pause()
            m.n_campaign_events += 1
            return
        if inj.kind == "maint_end":
            self.repair_shop.resume()
            m.n_campaign_events += 1
            return
        if inj.kind == "shock":
            m.n_domain_shocks += 1
            if m.domain_shocks:
                m.domain_shocks[inj.domain] += 1
        else:  # campaign kill
            m.n_campaign_events += 1

        fleet = self.scheduler.pools.fleet
        killed_running: List[Server] = []
        n_killed = 0
        for sid in inj.members:
            server = fleet.servers[sid]
            state = server.state
            if state is ServerState.RUNNING and sid in self._pos:
                killed_running.append(server)
            elif (state is ServerState.STANDBY
                    and server in self.scheduler.standbys):
                self.scheduler.standbys.remove(server)
                self.repair_shop.submit(server)
                n_killed += 1
            elif state in (ServerState.WORKING_FREE, ServerState.SPARE):
                # a popped-but-not-joined (in-flight) server still carries
                # its pool state but is in no free list; it survives
                if self.scheduler.pools.remove(server):
                    self.repair_shop.submit(server)
                    n_killed += 1
            elif state in (ServerState.REPAIR_AUTO, ServerState.REPAIR_MANUAL):
                self.repair_shop.rebreak(server)
                n_killed += 1
            # RETIRED servers are beyond further harm

        for server in killed_running:
            self._remove_running(server)
            self.repair_shop.submit(server)
        n_killed += len(killed_running)
        m.n_shock_killed += n_killed
        if not killed_running:
            return

        # group restart: replacements join now (the CTMC race resolves
        # the moves at the shock step); the job process serves the wait
        repl, t_fw, t_fs, shortfall = self.scheduler.draw_replacements(
            len(killed_running))
        for server in repl:
            self._add_running(server)
        self._deficit += shortfall
        wait = 0.0
        if t_fs:
            wait = (p.waiting_time + p.preemption_cost
                    + p.host_selection_time)
        elif t_fw:
            wait = p.host_selection_time
        self._pending_shock_wait = wait
        if self._stalling:
            return  # already group-stalled; the deficit grew, that's all
        if self._job_proc is not None and self._job_proc.is_alive:
            self._job_proc.interrupt("shock")

    def _shock_recover(self, t0: float) -> Generator:
        """Serve the group restart after a shock/kill hit running servers.

        Replacements were already drawn by :meth:`_apply_injection`; this
        charges the one-group restart wait — host selection if any pool
        draw, waiting + preemption if any spare draw — plus recovery, or
        stalls until repair returns refill the deficit (then recovery
        only, matching the CTMC ``to_stalled``/unstall path).  Downtime
        is recorded at the resolve instant with its planned value, the
        CTMC engine's record-at-resolve convention.
        """
        p, m, env = self.params, self.metrics, self.env
        if self._deficit > 0:
            self._stalling = True
            stall_start = env.now
            try:
                while self._deficit > 0:
                    server = yield from self.scheduler.group_stall_acquire()
                    self._add_running(server)
                    self._deficit -= 1
            finally:
                self._stalling = False
            m.stall_time += env.now - stall_start
            wait = env.now - t0
            serve = p.recovery_time
        else:
            wait = self._pending_shock_wait
            serve = wait + p.recovery_time
        m.waiting_durations.append(wait)
        m.recovery_durations.append(wait + p.recovery_time)
        m.recovery_overhead += p.recovery_time
        try:
            yield env.timeout(serve)
        except Interrupt:
            # another shock replaced the pending restart (CTMC: the
            # OVERHEAD timer is overwritten by the new shock_timer)
            yield from self._shock_recover(env.now)

    def _run_job_injected(self) -> Generator:
        """:meth:`run_job` variant racing the shock/campaign stream.

        A run whose injector never fires executes exactly the statements
        of the plain loop (the zero-rate / empty-campaign reduction
        tests require bit-identical metrics); injections arrive as
        ``Interrupt("shock")`` thrown by :meth:`injection_loop`.
        """
        p, m, env = self.params, self.metrics, self.env

        running = yield from self.scheduler.initial_allocation()
        for server in running:
            self._add_running(server)

        while self.remaining_work > 1e-9:
            if env.now >= p.max_sim_time:
                m.timed_out = True
                break
            if p.standbys_can_fail and self.scheduler.standbys:
                standby_good = [s for s in self.scheduler.standbys
                                if not s.is_bad]
                standby_bad = [s for s in self.scheduler.standbys
                               if s.is_bad]
                ttf, failed, is_systematic = self.sampler.sample_first_failure(
                    self.running_good + standby_good,
                    self.running_bad + standby_bad)
            else:
                ttf, failed, is_systematic = self.sampler.sample_first_failure(
                    self.running_good, self.running_bad)

            # checkpoint segment loop (see run_job), racing the injector:
            # an Interrupt mid-compute rolls back to the last durable
            # checkpoint; an Interrupt mid-WRITE loses nothing (durable
            # from write start) and charges only the partial write wall
            # time actually elapsed — the CTMC engine's in_ckpt timing.
            compute = 0.0
            ckpt_work = 0.0
            left = self.remaining_work
            completed = False
            interrupted = False
            while True:
                to_ckpt = (p.checkpoint_interval - ckpt_work
                           if p.checkpoint_interval > 0 else math.inf)
                seg_start = env.now
                write_start = None
                try:
                    if left <= ttf and left <= to_ckpt:
                        yield env.timeout(left)
                        compute += left
                        m.run_durations.append(compute)
                        m.useful_work += compute
                        self.remaining_work = 0.0
                        completed = True
                        break
                    if ttf <= to_ckpt:
                        yield env.timeout(ttf)
                        compute += ttf
                        ckpt_work += ttf
                        break
                    yield env.timeout(to_ckpt)
                    compute += to_ckpt
                    left -= to_ckpt
                    ttf -= to_ckpt
                    ckpt_work = 0.0
                    if p.checkpoint_cost > 0:
                        write_start = env.now
                        yield env.timeout(p.checkpoint_cost)
                        m.checkpoint_overhead += p.checkpoint_cost
                except Interrupt:
                    # shock/kill hit the group: the run interval ends
                    # here (banked like a failure), then group restart
                    if write_start is not None:
                        m.checkpoint_overhead += env.now - write_start
                    else:
                        elapsed = env.now - seg_start
                        compute += elapsed
                        ckpt_work += elapsed
                    self._bank_progress(compute, ckpt_work)
                    yield from self._shock_recover(env.now)
                    interrupted = True
                    break
            if completed:
                break
            if interrupted:
                continue

            m.n_failures += 1
            if is_systematic:
                m.n_systematic_failures += 1
            else:
                m.n_random_failures += 1
            assert failed is not None
            failed.record_failure(env.now, is_systematic)
            self._bank_progress(compute, ckpt_work)

            if failed.state is ServerState.STANDBY:
                self.scheduler.standbys.remove(failed)
                self.repair_shop.submit(failed)
                continue

            t_fail = env.now
            target = self._diagnose(failed)
            try:
                if target is not None:
                    self._remove_running(target)
                    self.repair_shop.submit(target)
                    replacement = yield from \
                        self.scheduler.acquire_replacement()
                    self._add_running(replacement)
                m.waiting_durations.append(env.now - t_fail)
                yield env.timeout(p.recovery_time)
                m.recovery_overhead += p.recovery_time
                m.recovery_durations.append(env.now - t_fail)
            except Interrupt:
                # shock mid-recovery: the CTMC race overwrites the
                # pending timer with the shock restart — close this
                # failure's books at the shock instant and restart
                inflight = self.scheduler.take_inflight()
                if inflight is not None:
                    self._add_running(inflight)
                # re-anchor the deficit on the true shortfall: an
                # interrupted stall/acquisition leaves the group short
                # beyond the shock's own tally
                self._deficit = max(0, p.job_size - len(self.running_good)
                                    - len(self.running_bad))
                m.waiting_durations.append(env.now - t_fail)
                m.recovery_overhead += p.recovery_time
                m.recovery_durations.append(env.now - t_fail)
                yield from self._shock_recover(env.now)

        m.total_time = env.now
        self.scheduler.release_all(self.running_good + self.running_bad)
        self.running_good.clear()
        self.running_bad.clear()
        return m
