"""Event-trace observability for simulation runs.

Counterpart of ``src/repro/core/trace.py``, kept line for line (pure
Python and numpy) so that the same Params and seed give the same draws
in the same order, and bit-identical results, in both packages.

Production fleets debug reliability policies from event timelines; the
simulator gives the same artifact: an optional tracer records every
state-changing event (failures, repairs, swaps, preemptions, stalls)
with timestamps and server identities, exportable to CSV / a
chrome://tracing-compatible JSON timeline.

Usage:
    tracer = Tracer()
    sim = ClusterSimulation(params)
    tracer.attach(sim)
    sim.run()
    tracer.write_csv("results/trace.csv")
    tracer.summary()
"""

from __future__ import annotations

import csv
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass(frozen=True)
class TraceEvent:
    time: float
    kind: str               # failure | repair_start | repair_done | swap...
    server: int             # -1 = cluster-level
    detail: str = ""


@dataclass
class Tracer:
    events: List[TraceEvent] = field(default_factory=list)

    def record(self, time: float, kind: str, server: int = -1,
               detail: str = "") -> None:
        self.events.append(TraceEvent(time, kind, server, detail))

    # -- attachment (monkey-patch observation points; the simulator stays
    # dependency-free when no tracer is attached) --------------------------
    def attach(self, sim) -> None:
        coord = sim.coordinator
        shop = sim.repair_shop
        sched = sim.scheduler
        env = sim.env
        tracer = self

        orig_diag = coord._diagnose

        def diagnose(failed):
            target = orig_diag(failed)
            tracer.record(env.now, "failure", failed.sid,
                          "bad" if failed.is_bad else "good")
            if target is None:
                tracer.record(env.now, "undiagnosed", failed.sid)
            elif target is not failed:
                tracer.record(env.now, "misdiagnosed", target.sid,
                              f"actual={failed.sid}")
            return target

        coord._diagnose = diagnose

        orig_submit = shop.submit

        def submit(server):
            tracer.record(env.now, "repair_start", server.sid)
            return orig_submit(server)

        shop.submit = submit

        orig_return = shop.on_return

        def on_return(server):
            tracer.record(env.now, "repair_done", server.sid,
                          "healed" if not server.is_bad else "still-bad")
            return orig_return(server)

        shop.on_return = on_return

        orig_acquire = sched.acquire_replacement

        def acquire_replacement():
            t0 = env.now
            server = yield from orig_acquire()
            kind = "standby_swap" if env.now == t0 else "host_selection"
            tracer.record(env.now, kind, server.sid,
                          f"wait={env.now - t0:.1f}")
            return server

        sched.acquire_replacement = acquire_replacement

        # fault-domain injections (shock | kill | maint_start | maint_end)
        if getattr(sim, "injector", None) is not None:
            orig_apply = coord._apply_injection

            def apply_injection(inj):
                tracer.record(env.now, inj.kind, -1,
                              f"domain={inj.domain} "
                              f"members={len(inj.members)}")
                return orig_apply(inj)

            coord._apply_injection = apply_injection

    # -- outputs -------------------------------------------------------------
    def write_csv(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["time_min", "kind", "server", "detail"])
            for e in self.events:
                w.writerow([f"{e.time:.3f}", e.kind, e.server, e.detail])

    def write_chrome_trace(self, path: str) -> None:
        """chrome://tracing 'trace events' JSON (instant events)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = [{
            "name": e.kind, "ph": "i", "ts": e.time * 60e6,  # min -> us
            "pid": 0, "tid": max(e.server, 0), "s": "g",
            "args": {"detail": e.detail, "server": e.server},
        } for e in self.events]
        with open(path, "w") as f:
            json.dump({"traceEvents": payload}, f)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    def repeat_offenders(self, top: int = 5) -> List[tuple]:
        """Servers with the most failures — retirement-policy candidates."""
        per: Dict[int, int] = {}
        for e in self.events:
            if e.kind == "failure":
                per[e.server] = per.get(e.server, 0) + 1
        return sorted(per.items(), key=lambda kv: -kv[1])[:top]

    def summary(self) -> str:
        lines = [f"{len(self.events)} events"]
        for kind, n in sorted(self.counts().items()):
            lines.append(f"  {kind:16s} {n}")
        off = self.repeat_offenders()
        if off:
            lines.append("  repeat offenders: "
                         + ", ".join(f"s{sid}x{n}" for sid, n in off))
        return "\n".join(lines)
