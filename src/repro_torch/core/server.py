"""Server module: per-server state, the fleet, and the failure sampler.

Counterpart of ``src/repro/core/server.py``, kept line for line (pure
Python and numpy) so that the same Params and seed give the same draws
in the same order, and bit-identical results, in both packages.

Paper §III-C module (1): "Server: Keeps track of each server's failure and
recovery. When a job is started on a server, a failure process starts at the
same time. ... Note that we approximate this process by analytical
calculation of the failure rates."

We follow the paper's own approximation: rather than scheduling one event
per server (4096 heap entries re-sampled on every restart), the fleet-wide
*first* failure is sampled analytically:

  * exponential distributions (default): the minimum of N exponential clocks
    is exponential with the summed rate; the firing clock is chosen
    proportionally to its rate.  Exact, O(1) per failure.
  * other distributions: per-server samples are drawn vectorized with numpy
    and the argmin taken.  Exact, O(N) per restart.

Both honor the paper's semantics that failure clocks (re)start whenever the
job (re)starts on a server.
"""

from __future__ import annotations

import enum
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .distributions import failure_distribution
from .params import Params


class ServerState(enum.Enum):
    WORKING_FREE = "working_free"   # powered-on, ready in the working pool
    SPARE = "spare"                 # in spare pool, running other jobs
    RUNNING = "running"             # executing the AI job
    STANDBY = "standby"             # allocated to the job as warm standby
    REPAIR_AUTO = "repair_auto"
    REPAIR_MANUAL = "repair_manual"
    RETIRED = "retired"


class Server:
    """One server's identity, health, and failure history."""

    __slots__ = ("sid", "is_bad", "state", "origin_spare", "failure_times",
                 "n_failures", "n_systematic", "n_random", "n_repairs")

    def __init__(self, sid: int, is_bad: bool, origin_spare: bool):
        self.sid = sid
        self.is_bad = is_bad
        self.state = ServerState.SPARE if origin_spare else ServerState.WORKING_FREE
        self.origin_spare = origin_spare
        self.failure_times: List[float] = []
        self.n_failures = 0
        self.n_systematic = 0
        self.n_random = 0
        self.n_repairs = 0

    def record_failure(self, now: float, systematic: bool) -> None:
        self.failure_times.append(now)
        self.n_failures += 1
        if systematic:
            self.n_systematic += 1
        else:
            self.n_random += 1

    def failures_in_window(self, now: float, window: float) -> int:
        cutoff = now - window
        # failure_times is append-only sorted; scan from the back
        count = 0
        for t in reversed(self.failure_times):
            if t < cutoff:
                break
            count += 1
        return count

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Server({self.sid}, {'bad' if self.is_bad else 'good'}, "
                f"{self.state.value})")


class Fleet:
    """All servers in the cluster (working pool + spare pool)."""

    def __init__(self, params: Params, rng: np.random.Generator):
        self.params = params
        self.rng = rng
        total = params.working_pool_size + params.spare_pool_size
        self.servers: List[Server] = [
            Server(sid, False, origin_spare=(sid >= params.working_pool_size))
            for sid in range(total)
        ]
        self._assign_bad_set()

    def _assign_bad_set(self) -> None:
        total = len(self.servers)
        n_bad = int(round(self.params.systematic_failure_fraction * total))
        bad_ids = self.rng.choice(total, size=n_bad, replace=False)
        flags = np.zeros(total, dtype=bool)
        flags[bad_ids] = True
        for server, flag in zip(self.servers, flags):
            server.is_bad = bool(flag)

    def regenerate_bad_set(self) -> None:
        """Assumption 1, case 2: periodically re-draw which servers are bad
        (aging / new hardware models entering the fleet)."""
        self._assign_bad_set()


class FailureSampler:
    """Samples the fleet-wide first failure among running servers."""

    def __init__(self, params: Params, rng: np.random.Generator):
        self.params = params
        self.rng = rng
        self._exponential = params.failure_distribution.lower() == "exponential"
        self._rand_dist = failure_distribution(
            params.failure_distribution, params.random_failure_rate,
            **params.distribution_kwargs)
        self._sys_dist = failure_distribution(
            params.failure_distribution, params.systematic_failure_rate,
            **params.distribution_kwargs)

    def sample_first_failure(
        self, good: Sequence[Server], bad: Sequence[Server],
    ) -> Tuple[float, Optional[Server], bool]:
        """Return (time_to_failure, failing_server, is_systematic).

        ``good``/``bad`` are indexable collections of currently-executing
        servers by health class.  Returns (inf, None, False) if no failure
        can occur.
        """
        if self._exponential:
            return self._sample_exponential(good, bad)
        return self._sample_generic(good, bad)

    # -- exact O(1) exponential path ---------------------------------------
    def _sample_exponential(self, good, bad):
        p = self.params
        n_good, n_bad = len(good), len(bad)
        # three competing clock families: good-random, bad-random, bad-systematic
        r_gr = n_good * p.random_failure_rate
        r_br = n_bad * p.random_failure_rate
        r_bs = n_bad * p.systematic_failure_rate
        total = r_gr + r_br + r_bs
        if total <= 0.0:
            return math.inf, None, False
        ttf = float(self.rng.exponential(1.0 / total))
        u = self.rng.random() * total
        if u < r_gr:
            server = good[int(self.rng.integers(n_good))]
            return ttf, server, False
        if u < r_gr + r_br:
            server = bad[int(self.rng.integers(n_bad))]
            return ttf, server, False
        server = bad[int(self.rng.integers(n_bad))]
        return ttf, server, True

    # -- generic vectorized path (lognormal / weibull / user) ---------------
    def _sample_generic(self, good, bad):
        n_good, n_bad = len(good), len(bad)
        if n_good + n_bad == 0:
            return math.inf, None, False
        best_t, best_server, best_sys = math.inf, None, False
        if n_good:
            t = np.array([self._rand_dist.sample(self.rng) for _ in range(n_good)])
            i = int(np.argmin(t))
            if t[i] < best_t:
                best_t, best_server, best_sys = float(t[i]), good[i], False
        if n_bad:
            t_r = np.array([self._rand_dist.sample(self.rng) for _ in range(n_bad)])
            t_s = np.array([self._sys_dist.sample(self.rng) for _ in range(n_bad)])
            ir, is_ = int(np.argmin(t_r)), int(np.argmin(t_s))
            if t_r[ir] < best_t:
                best_t, best_server, best_sys = float(t_r[ir]), bad[ir], False
            if t_s[is_] < best_t:
                best_t, best_server, best_sys = float(t_s[is_]), bad[is_], True
        if math.isinf(best_t):
            return math.inf, None, False
        return best_t, best_server, best_sys
