"""Repairs module: diagnosis -> automated repair -> manual repair -> return.

Counterpart of ``src/repro/core/repair.py``, kept line for line (pure
Python and numpy) so that the same Params and seed give the same draws
in the same order, and bit-identical results, in both packages.

Paper §III-C module (4) with assumptions 3-5:

  * upon failure a server first undergoes *automated* repair; with
    probability ``1 - automated_repair_probability`` the problem is beyond
    automated scope and the server escalates to *manual* repair (after the
    automated attempt's time has been spent);
  * both repair kinds can *silently fail* (status says repaired, problem
    persists) with their respective failure probabilities;
  * a successful repair converts a bad server to good (stateless repairs);
    repairing a good server (random failure / misdiagnosis) is a no-op;
  * repair durations are exponentially distributed around the configured
    means (assumption 4); pluggable like failure distributions;
  * optional score-based retirement: a server exceeding
    ``retirement_threshold`` failures within ``retirement_window`` minutes
    is permanently removed instead of reintegrated;
  * optional finite capacity (``Params.repair_servers``): at most that
    many servers are *in service* at once; the rest queue inside the
    shop.  A departure admits one queued server chosen uniformly at
    random — class/owner-proportional over the queued counts, which is
    what the vectorized CTMC engine's compartment model needs for
    exact-in-law parity.  Escalation to manual repair keeps its service
    slot (the server never leaves the technician's bench).  Capacity 0
    (default) queues nothing and draws nothing extra from the RNG, so
    unlimited-shop runs stay bit-identical to the pre-capacity engine.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from .distributions import Distribution, make_distribution
from .engine import Environment, Event, Interrupt
from .metrics import RunResult
from .params import Params
from .server import Server, ServerState


def repair_distributions(params: Params) -> Tuple[Distribution, Distribution]:
    """(automated, manual) repair-duration distributions for these Params.

    The single construction point for BOTH engines: the event engine's
    :class:`RepairShop` samples from these objects, and the CTMC engine's
    repair classifier (:func:`repro_torch.core.hazards.repair_kind`) reads
    the same instances — so a kwarg default retuned in
    :mod:`repro_torch.core.distributions` moves the two engines together.
    """
    kw = params.distribution_kwargs
    return (make_distribution(params.repair_distribution,
                              params.auto_repair_time, **kw),
            make_distribution(params.repair_distribution,
                              params.manual_repair_time, **kw))


class RepairShop:
    def __init__(self, env: Environment, params: Params,
                 rng: np.random.Generator, metrics: RunResult,
                 on_return: Callable[[Server], None],
                 on_retire: Optional[Callable[[Server], None]] = None):
        self.env = env
        self.params = params
        self.rng = rng
        self.metrics = metrics
        self.on_return = on_return
        self.on_retire = on_retire
        self.in_repair: set = set()
        #: service-slot bound (0 = unlimited) + the waiting line behind it
        self.capacity = params.repair_servers
        self.queue: list = []
        self._n_active = 0
        #: lifetime count of submissions that had to queue (shop full) —
        #: the event twin of the CTMC engine's n_shop_queued lane
        self.n_queued_events = 0
        self._auto_dist, self._manual_dist = repair_distributions(params)
        #: sid -> live repair Process (fault-domain rebreaks / maintenance
        #: pauses need a handle to interrupt specific stages)
        self._procs: dict = {}
        self._paused = False
        self._resume_events: list = []

    # -- public API ----------------------------------------------------------
    def submit(self, server: Server) -> None:
        """Send a failed server through the repair pipeline (async).

        With finite capacity, a full shop parks the server in the queue
        instead; it is still "in the shop" (``in_repair``) for
        conservation accounting, just not yet in service.
        """
        if server in self.in_repair:
            raise RuntimeError(f"{server!r} already in repair")
        self.in_repair.add(server)
        if self.capacity and self._n_active >= self.capacity:
            server.state = ServerState.REPAIR_AUTO   # waiting for the bench
            self.queue.append(server)
            self.n_queued_events += 1
            return
        self._start_service(server)

    def _start_service(self, server: Server) -> None:
        self._n_active += 1
        self._procs[server.sid] = self.env.process(
            self._repair_process(server), name=f"repair-{server.sid}")

    def _depart(self) -> None:
        """A server left service: free its slot and admit from the queue.

        Admission is a *uniform* draw over the queued servers, not FIFO:
        uniform-over-servers equals proportional-over-(class, owner)
        counts, the exchangeability property that makes the compiled
        CTMC engine's count-based admission exact in law.  An empty
        queue draws nothing, so capacity-0 runs never touch the RNG.
        """
        self._n_active -= 1
        if self.queue and (not self.capacity
                           or self._n_active < self.capacity):
            idx = int(self.rng.integers(len(self.queue)))
            nxt = self.queue.pop(idx)
            self._start_service(nxt)

    @property
    def n_in_repair(self) -> int:
        return len(self.in_repair)

    @property
    def n_queued(self) -> int:
        return len(self.queue)

    # -- fault-domain hooks (see repro_torch.core.faultdomains) --------------------
    def pause(self) -> None:
        """Maintenance window opens: freeze every in-flight repair stage.

        Stages keep their remaining duration and resume where they left
        off when :meth:`resume` fires (the CTMC engine gates the same
        window by zeroing repair rates, exact-in-law for exponentials).
        """
        self._paused = True
        for proc in list(self._procs.values()):
            if proc.is_alive and proc._target is not None:
                proc.interrupt("pause")

    def resume(self) -> None:
        """Maintenance window closes: paused stages pick back up."""
        self._paused = False
        for evt in self._resume_events:
            if not evt.triggered:
                evt.succeed()
        self._resume_events.clear()

    def rebreak(self, server: Server) -> None:
        """A domain shock struck a server already in the shop: its current
        repair stage restarts with a fresh draw.  Exact-in-law a no-op
        under exponential repairs (memorylessness); real progress loss
        under Weibull / lognormal / deterministic repairs."""
        proc = self._procs.get(server.sid)
        if proc is not None and proc.is_alive and proc._target is not None:
            proc.interrupt("rebreak")

    def _stage_wait(self, dist: Distribution):
        """Serve one repair stage, honoring pauses and re-breaks.

        The duration is sampled *before* the pause check so a run whose
        campaign never fires consumes the RNG stream in exactly the
        baseline order (the zero-rate reduction tests rely on this).
        """
        remaining = dist.sample(self.rng)
        while True:
            if self._paused:
                evt: Event = self.env.event()
                self._resume_events.append(evt)
                try:
                    yield evt
                except Interrupt as itr:
                    if itr.cause == "rebreak":
                        remaining = dist.sample(self.rng)
                continue
            start = self.env.now
            try:
                yield self.env.timeout(remaining)
                return
            except Interrupt as itr:
                if itr.cause == "rebreak":
                    remaining = dist.sample(self.rng)
                else:  # pause: keep whatever stage time is left
                    remaining = max(remaining - (self.env.now - start), 0.0)

    # -- pipeline ----------------------------------------------------------
    def _repair_process(self, server: Server):
        p, rng = self.params, self.rng
        server.n_repairs += 1

        # Stage 1: automated testing + repair (always attempted first).
        server.state = ServerState.REPAIR_AUTO
        yield from self._stage_wait(self._auto_dist)
        self.metrics.n_auto_repairs += 1

        if rng.random() < p.automated_repair_probability:
            # Problem within automated scope; did the repair actually work?
            success = rng.random() >= p.auto_repair_failure_probability
        else:
            # Beyond automated scope -> manual repair (assumption 3).
            server.state = ServerState.REPAIR_MANUAL
            yield from self._stage_wait(self._manual_dist)
            self.metrics.n_manual_repairs += 1
            success = rng.random() >= p.manual_repair_failure_probability

        if success:
            # Assumption 5: a successful repair makes a bad server good.
            server.is_bad = False
        else:
            self.metrics.n_failed_repairs += 1

        self.in_repair.discard(server)
        self._procs.pop(server.sid, None)
        self._depart()

        # Score-based retirement (extension; off when threshold == 0).
        if (p.retirement_threshold > 0 and
                server.failures_in_window(self.env.now, p.retirement_window)
                >= p.retirement_threshold):
            self.metrics.n_retired += 1
            if self.on_retire is not None:
                self.on_retire(server)
            return

        # Reintegrate: Scheduler decides job-return vs pool-return.
        self.on_return(server)
