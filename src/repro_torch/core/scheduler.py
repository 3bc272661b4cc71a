"""Scheduler module: host selection, warm standbys, replacements, stalls.

Counterpart of ``src/repro/core/scheduler.py``, kept line for line (pure
Python and numpy) so that the same Params and seed give the same draws
in the same order, and bit-identical results, in both packages.

Paper §III-C module (3): "Assigns servers to the job from a list of chosen
servers (host selection), and starts the job on the servers. It also keeps
track of the remaining length of the job and failed servers."

Replacement waterfall on a failure (paper §II-B):

  1. warm standby        -> swap-in, NO host selection, recovery only
  2. working-pool free   -> host_selection_time, then recovery
  3. spare pool          -> waiting_time (preempt other job) +
                            host_selection_time, then recovery
  4. nothing anywhere    -> STALL until a repaired server returns

Repaired servers return to *this* job (as standbys) if it still wants them
— "a server is returned to the job after repair if it was originally
assigned to the same job before it failed, without going through host
selection again" — otherwise to their origin pool.
"""

from __future__ import annotations

from typing import Generator, List, Optional, Set

from .engine import Environment, Event, Interrupt
from .metrics import RunResult
from .params import Params
from .pool import PoolManager
from .server import Server, ServerState


class Scheduler:
    def __init__(self, env: Environment, params: Params, pools: PoolManager,
                 metrics: RunResult):
        self.env = env
        self.params = params
        self.pools = pools
        self.metrics = metrics
        self.standbys: List[Server] = []
        #: servers the job has ever claimed and not released (for returns)
        self.job_members: Set[int] = set()
        self.job_active = False
        self._stall_event: Optional[Event] = None
        self._stall_server: Optional[Server] = None
        #: server popped from a pool by an in-flight acquisition (between
        #: the pop and the post-wait join) — a fault-domain interrupt
        #: mid-acquisition recovers it via :meth:`take_inflight` instead
        #: of leaking it
        self._inflight: Optional[Server] = None

    # -- initial allocation (t=0 host selection) ----------------------------
    def initial_allocation(self) -> Generator:
        """Select job_size + warm_standbys hosts from the working pool."""
        p = self.params
        yield self.env.timeout(p.host_selection_time)
        running: List[Server] = []
        for _ in range(p.job_size):
            server = self.pools.pop_working()
            if server is None:  # validate() precludes this at t=0
                raise RuntimeError("working pool cannot host the job")
            server.state = ServerState.RUNNING
            self.job_members.add(server.sid)
            running.append(server)
        for _ in range(p.warm_standbys):
            server = self.pools.pop_working()
            if server is None:
                break  # fewer standbys than requested; job still starts
            server.state = ServerState.STANDBY
            self.job_members.add(server.sid)
            self.standbys.append(server)
        self.job_active = True
        return running

    # -- replacement waterfall ------------------------------------------------
    def acquire_replacement(self) -> Generator:
        """Yield timeouts per the waterfall; returns the acquired Server."""
        p, m = self.params, self.metrics

        # 1. warm standby: immediate, no host selection.
        if self.standbys:
            server = self.standbys.pop()
            m.n_standby_swaps += 1
            server.state = ServerState.RUNNING
            return server

        # 2. working pool: pay a host-selection round.
        server = self.pools.pop_working()
        if server is not None:
            self._inflight = server
            yield self.env.timeout(p.host_selection_time)
            self._inflight = None
            m.n_host_selections += 1
            server.state = ServerState.RUNNING
            self.job_members.add(server.sid)
            return server

        # 3. spare pool: preempt another job, then host selection.
        server = self.pools.pop_spare()
        if server is not None:
            self._inflight = server
            yield self.env.timeout(p.waiting_time + p.preemption_cost)
            m.n_preemptions += 1
            yield self.env.timeout(p.host_selection_time)
            self._inflight = None
            m.n_host_selections += 1
            server.state = ServerState.RUNNING
            self.job_members.add(server.sid)
            return server

        # 4. stall: wait for any server to come back from repair.
        stall_start = self.env.now
        server = yield from self._stall_until_available()
        m.stall_time += self.env.now - stall_start
        # Returned servers rejoin without host selection if they were job
        # members; fresh pool servers pay host selection.
        if server.sid not in self.job_members:
            self._inflight = server
            yield self.env.timeout(p.host_selection_time)
            self._inflight = None
            m.n_host_selections += 1
            self.job_members.add(server.sid)
        server.state = ServerState.RUNNING
        return server

    def take_inflight(self) -> Optional[Server]:
        """Recover the server an interrupted acquisition had in flight.

        The CTMC race joins replacements to the run set at the failure
        step itself, so a shock arriving mid-acquisition must not lose
        the popped server: the coordinator claims it here and counts it
        as joined.
        """
        server, self._inflight = self._inflight, None
        if server is not None:
            server.state = ServerState.RUNNING
            self.job_members.add(server.sid)
        return server

    # -- fault-domain group restarts (see repro_torch.core.faultdomains) ----------
    def draw_replacements(self, n: int):
        """Zero-time bulk waterfall draw for a domain-shock group restart.

        Mirrors the CTMC race, which resolves all replacement *moves* at
        the shock step and charges the time cost as one group restart:
        returns ``(servers, n_working, n_spare, shortfall)`` with the
        per-server counters (standby swaps, host selections, preemptions)
        already recorded.  The caller charges the restart wait.
        """
        m = self.metrics
        out: List[Server] = []
        t_sb = t_fw = t_fs = 0
        for _ in range(n):
            if self.standbys:
                server = self.standbys.pop()
                t_sb += 1
            else:
                server = self.pools.pop_working()
                if server is not None:
                    t_fw += 1
                else:
                    server = self.pools.pop_spare()
                    if server is not None:
                        t_fs += 1
                    else:
                        break
            server.state = ServerState.RUNNING
            self.job_members.add(server.sid)
            out.append(server)
        m.n_standby_swaps += t_sb
        m.n_host_selections += t_fw + t_fs
        m.n_preemptions += t_fs
        return out, t_fw, t_fs, n - len(out)

    def group_stall_acquire(self) -> Generator:
        """One deficit-refill acquisition for a shocked group.

        Matches the CTMC ``to_stalled`` join: a returning server joins
        the run set directly with no host-selection surcharge (the
        group pays a single recovery after the deficit clears).
        """
        server = yield from self._stall_until_available()
        server.state = ServerState.RUNNING
        self.job_members.add(server.sid)
        return server

    def _stall_until_available(self) -> Generator:
        """Block until on_server_return / pool release hands us a server."""
        self._stall_event = self.env.event()
        self._stall_server = None

        def _watcher(server: Server) -> None:
            # a release to a pool while we starve: grab it
            if self._stall_event is not None and not self._stall_event.triggered:
                got = (self.pools.pop_working() or self.pools.pop_spare())
                if got is not None:
                    self._stall_server = got
                    self._stall_event.succeed(got)

        self.pools.add_release_watcher(_watcher)
        try:
            # A direct hand-off via on_server_return may already have fired.
            yield self._stall_event
            assert self._stall_server is not None
            return self._stall_server
        except Interrupt:
            # a fault-domain injection interrupted the stall: a hand-off
            # may have landed between succeed() and our resumption —
            # park it in _inflight so the coordinator can claim it
            if self._stall_server is not None:
                self._inflight = self._stall_server
            raise
        finally:
            self.pools.remove_release_watcher(_watcher)
            self._stall_event = None
            self._stall_server = None

    #: when a fault-domain scenario is active, repaired servers backfill
    #: the job's standby complement first *regardless of membership* —
    #: after a correlated outage the degraded job is restored before the
    #: pools are (and the CTMC engine's return lane, which carries no
    #: membership, has exactly these semantics).  False (default) keeps
    #: the paper rule: only original job members return to the job.
    standby_refill_any = False

    # -- repaired-server returns --------------------------------------------
    def on_server_return(self, server: Server) -> None:
        """RepairShop callback: decide job-return vs pool-return."""
        # starved job gets the server immediately (direct hand-off)
        if self._stall_event is not None and not self._stall_event.triggered:
            self._stall_server = server
            self._stall_event.succeed(server)
            return
        if (self.job_active
                and (server.sid in self.job_members or self.standby_refill_any)
                and len(self.standbys) < self.params.warm_standbys):
            server.state = ServerState.STANDBY
            self.job_members.add(server.sid)
            self.standbys.append(server)
            return
        # no longer needed by the job
        self.job_members.discard(server.sid)
        self.pools.push(server)

    def on_server_retired(self, server: Server) -> None:
        self.job_members.discard(server.sid)
        self.pools.retire(server)

    # -- teardown ----------------------------------------------------------------
    def release_all(self, running: List[Server]) -> None:
        """Job finished: release running servers and standbys to pools."""
        self.job_active = False
        for server in running + self.standbys:
            self.job_members.discard(server.sid)
            self.pools.push(server)
        self.standbys.clear()
