"""Generator-coroutine discrete event simulation engine.

Counterpart of ``src/repro/core/engine.py``, kept line for line (pure
Python and numpy) so that the same Params and seed give the same draws
in the same order, and bit-identical results, in both packages.

The paper implements AIReSim on SimPy; SimPy is not available in this
environment, so this module provides an API-compatible subset built from
scratch (Environment / Process / Timeout / Event / Interrupt / conditions).
It is deliberately small and allocation-light: the event heap stores
``(time, priority, eid, event)`` tuples and processes are plain generators.

Semantics mirror SimPy 4:
  * ``env.process(gen)`` turns a generator into a schedulable Process.
  * Processes ``yield`` events; they resume when the event triggers.
  * ``proc.interrupt(cause)`` throws :class:`Interrupt` into the generator
    at the current simulation time (deregistering the pending wait).
  * Events may ``succeed(value)`` or ``fail(exc)`` exactly once.
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, Generator, Iterable, List, Optional

# Scheduling priorities (lower runs first at equal timestamps).
URGENT = 0
NORMAL = 1


class Interrupt(Exception):
    """Thrown into a process by :meth:`Process.interrupt`."""

    def __init__(self, cause: Any = None):
        super().__init__(cause)
        self.cause = cause


class StopSimulation(Exception):
    """Raised internally to end :meth:`Environment.run`."""


class Event:
    """A one-shot occurrence processes can wait on."""

    __slots__ = ("env", "callbacks", "_value", "_ok", "_scheduled", "_defused")

    def __init__(self, env: "Environment"):
        self.env = env
        self.callbacks: Optional[List[Callable[["Event"], None]]] = []
        self._value: Any = None
        self._ok: Optional[bool] = None  # None = untriggered
        self._scheduled = False
        self._defused = False

    # -- state ------------------------------------------------------------
    @property
    def triggered(self) -> bool:
        return self._ok is not None

    @property
    def processed(self) -> bool:
        return self.callbacks is None

    @property
    def ok(self) -> bool:
        return bool(self._ok)

    @property
    def value(self) -> Any:
        return self._value

    # -- triggering -------------------------------------------------------
    def succeed(self, value: Any = None) -> "Event":
        if self._ok is not None:
            raise RuntimeError(f"{self!r} already triggered")
        self._ok = True
        self._value = value
        self.env._schedule(self, NORMAL, 0.0)
        return self

    def fail(self, exc: BaseException) -> "Event":
        if self._ok is not None:
            raise RuntimeError(f"{self!r} already triggered")
        self._ok = False
        self._value = exc
        self.env._schedule(self, NORMAL, 0.0)
        return self

    def defuse(self) -> None:
        """Mark a failed event as handled so it doesn't crash the run."""
        self._defused = True


class Timeout(Event):
    """Event that triggers after a fixed simulated delay."""

    __slots__ = ("delay",)

    def __init__(self, env: "Environment", delay: float, value: Any = None):
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        super().__init__(env)
        self.delay = delay
        self._ok = True
        self._value = value
        env._schedule(self, NORMAL, delay)


class Initialize(Event):
    """Internal: schedules the first resumption of a new process."""

    __slots__ = ()

    def __init__(self, env: "Environment", process: "Process"):
        super().__init__(env)
        self.callbacks.append(process._resume)
        self._ok = True
        env._schedule(self, URGENT, 0.0)


class Process(Event):
    """Wraps a generator; itself an event that triggers on completion."""

    __slots__ = ("_generator", "_target", "name")

    def __init__(self, env: "Environment", generator: Generator, name: str = ""):
        super().__init__(env)
        self._generator = generator
        self._target: Optional[Event] = None
        self.name = name or getattr(generator, "__name__", "process")
        Initialize(env, self)

    @property
    def is_alive(self) -> bool:
        return self._ok is None

    def interrupt(self, cause: Any = None) -> None:
        if self._ok is not None:
            return  # already finished; interrupt is a no-op
        # Deregister from whatever it is waiting on.
        target = self._target
        if target is not None and target.callbacks is not None:
            try:
                target.callbacks.remove(self._resume)
            except ValueError:
                pass
        self._target = None
        # Resume immediately (urgent) with an Interrupt.
        evt = Event(self.env)
        evt._ok = False
        evt._value = Interrupt(cause)
        evt._defused = True
        evt.callbacks.append(self._resume)
        self.env._schedule(evt, URGENT, 0.0)

    # -- driving ----------------------------------------------------------
    def _resume(self, event: Event) -> None:
        self.env._active_proc = self
        try:
            if event._ok:
                next_evt = self._generator.send(event._value)
            else:
                # event carries an exception (failed event or interrupt)
                next_evt = self._generator.throw(event._value)
        except StopIteration as stop:
            self._ok = True
            self._value = stop.value
            self.env._schedule(self, NORMAL, 0.0)
            self.env._active_proc = None
            return
        except BaseException as exc:  # propagate through the process event
            self._ok = False
            self._value = exc
            self._defused = False
            self.env._schedule(self, NORMAL, 0.0)
            self.env._active_proc = None
            return
        self.env._active_proc = None
        if not isinstance(next_evt, Event):
            raise RuntimeError(
                f"process {self.name} yielded non-event {next_evt!r}")
        if next_evt.callbacks is None:
            # already processed -> resume immediately via a relay event
            evt = Event(self.env)
            evt._ok = next_evt._ok
            evt._value = next_evt._value
            evt._defused = True
            evt.callbacks.append(self._resume)
            self.env._schedule(evt, URGENT, 0.0)
            self._target = evt
        else:
            next_evt.callbacks.append(self._resume)
            if next_evt._ok is False:
                next_evt._defused = True  # waiting on it handles failure
            self._target = next_evt


class Condition(Event):
    """Triggers when ``check(count_done, total)`` is satisfied."""

    __slots__ = ("_events", "_check", "_done")

    def __init__(self, env: "Environment", events: Iterable[Event],
                 check: Callable[[int, int], bool]):
        super().__init__(env)
        self._events = list(events)
        self._check = check
        self._done = 0
        if not self._events:
            self.succeed({})
            return
        for evt in self._events:
            if evt.callbacks is None:
                self._on_event(evt)
            else:
                evt.callbacks.append(self._on_event)

    def _on_event(self, evt: Event) -> None:
        if self._ok is not None:
            return
        if not evt._ok:
            evt.defuse()
            self.fail(evt._value)
            return
        self._done += 1
        if self._check(self._done, len(self._events)):
            self.succeed({e: e._value for e in self._events if e.processed})


class Environment:
    """Owner of the clock and the event heap."""

    def __init__(self, initial_time: float = 0.0):
        self._now = float(initial_time)
        self._heap: List[tuple] = []
        self._eid = 0
        self._active_proc: Optional[Process] = None
        self.event_count = 0  # processed events; used by perf benchmarks

    @property
    def now(self) -> float:
        return self._now

    @property
    def active_process(self) -> Optional[Process]:
        return self._active_proc

    # -- factories ---------------------------------------------------------
    def event(self) -> Event:
        return Event(self)

    def timeout(self, delay: float, value: Any = None) -> Timeout:
        return Timeout(self, delay, value)

    def process(self, generator: Generator, name: str = "") -> Process:
        return Process(self, generator, name)

    def any_of(self, events: Iterable[Event]) -> Condition:
        return Condition(self, events, lambda done, total: done >= 1)

    def all_of(self, events: Iterable[Event]) -> Condition:
        return Condition(self, events, lambda done, total: done == total)

    # -- scheduling ----------------------------------------------------------
    def _schedule(self, event: Event, priority: int, delay: float) -> None:
        if event._scheduled:
            return
        event._scheduled = True
        self._eid += 1
        heapq.heappush(self._heap, (self._now + delay, priority, self._eid, event))

    def step(self) -> None:
        when, _prio, _eid, event = heapq.heappop(self._heap)
        self._now = when
        callbacks, event.callbacks = event.callbacks, None
        self.event_count += 1
        for cb in callbacks:
            cb(event)
        if event._ok is False and not event._defused:
            raise event._value  # unhandled failure

    def run(self, until: Optional[float] = None) -> Any:
        """Run until the heap drains or simulated time reaches ``until``."""
        if until is not None:
            def _stop(_evt: Event) -> None:
                raise StopSimulation()
            stopper = Event(self)
            stopper._ok = True
            stopper.callbacks.append(_stop)
            self._schedule(stopper, URGENT, max(0.0, until - self._now))
        try:
            while self._heap:
                self.step()
        except StopSimulation:
            self._now = until
        return self._now

    def run_until_process(self, proc: Process) -> Any:
        """Run until ``proc`` completes; returns its value (raises its error)."""
        while self._heap and proc._ok is None:
            self.step()
        if proc._ok is None:
            raise RuntimeError(f"deadlock: {proc.name} never completed "
                               f"(heap drained at t={self._now})")
        if not proc._ok:
            raise proc._value
        return proc._value
