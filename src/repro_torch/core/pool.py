"""Pool module: working-pool / spare-pool bookkeeping.

Counterpart of ``src/repro/core/pool.py``, kept line for line (pure
Python and numpy) so that the same Params and seed give the same draws
in the same order, and bit-identical results, in both packages.

Paper §III-C module (5): "Pool: Keeps track of the servers in working and
spare pools, and moves servers between them if needed."

Pure bookkeeping — all time costs (host selection, spare-pool preemption
waiting) are charged by the Scheduler, which owns the simulation clock
interactions.  Servers released when no longer needed return to their
*origin* pool: spare-pool servers go back to running other jobs (paper:
"When the need for additional servers for the AI job subsides, these
servers are returned to the spare pool").
"""

from __future__ import annotations

from typing import Callable, List, Optional

from .params import Params
from .server import Fleet, Server, ServerState


class PoolManager:
    def __init__(self, params: Params, fleet: Fleet):
        self.params = params
        self.fleet = fleet
        self.working_free: List[Server] = [
            s for s in fleet.servers if not s.origin_spare]
        self.spare_free: List[Server] = [
            s for s in fleet.servers if s.origin_spare]
        self.retired: List[Server] = []
        #: callbacks fired when a server is released back to a pool — the
        #: Scheduler registers here to un-stall a starved job.
        self._release_watchers: List[Callable[[Server], None]] = []

    # -- acquisition -------------------------------------------------------
    def pop_working(self) -> Optional[Server]:
        """Take a powered-on ready server from the working pool."""
        if not self.working_free:
            return None
        server = self.working_free.pop()
        return server

    def pop_spare(self) -> Optional[Server]:
        """Take a server from the spare pool (caller charges waiting_time)."""
        if not self.spare_free:
            return None
        server = self.spare_free.pop()
        return server

    def remove(self, server: Server) -> bool:
        """Take a *specific* free server out of its pool (domain kills).

        Returns False if the server is not currently sitting in a free
        list — e.g. it was popped by an in-flight replacement
        acquisition and is in limbo between pool and job.
        """
        for lst in (self.working_free, self.spare_free):
            try:
                lst.remove(server)
                return True
            except ValueError:
                pass
        return False

    # -- release -----------------------------------------------------------
    def push(self, server: Server) -> None:
        """Return a server to its origin pool and notify watchers."""
        if server.state is ServerState.RETIRED:
            raise ValueError(f"cannot release retired {server!r}")
        if server.origin_spare:
            server.state = ServerState.SPARE
            self.spare_free.append(server)
        else:
            server.state = ServerState.WORKING_FREE
            self.working_free.append(server)
        for watcher in list(self._release_watchers):
            watcher(server)

    def retire(self, server: Server) -> None:
        server.state = ServerState.RETIRED
        self.retired.append(server)

    # -- stall support -------------------------------------------------------
    def add_release_watcher(self, cb: Callable[[Server], None]) -> None:
        self._release_watchers.append(cb)

    def remove_release_watcher(self, cb: Callable[[Server], None]) -> None:
        try:
            self._release_watchers.remove(cb)
        except ValueError:
            pass

    # -- accounting ------------------------------------------------------------
    @property
    def n_working_free(self) -> int:
        return len(self.working_free)

    @property
    def n_spare_free(self) -> int:
        return len(self.spare_free)

    @property
    def n_retired(self) -> int:
        return len(self.retired)

    def conservation_counts(self) -> dict:
        """Server-count snapshot for the conservation invariant tests."""
        by_state: dict = {}
        for s in self.fleet.servers:
            by_state[s.state.value] = by_state.get(s.state.value, 0) + 1
        return by_state
