"""The port's DES engine against the reference's, case for case.

Every case of the reference's engine tests runs on both packages'
``Environment`` (``repro_torch.core.engine`` and ``repro.core.engine``):
the port's copy must order, wake, interrupt and fail processes exactly as
the reference does, and a seeded mix of timeouts, events, interrupts and
``any_of`` races must leave the same log in both.
"""

import numpy as np
import pytest

from repro_torch.core import engine as t_engine

jax = pytest.importorskip("jax")

from repro.core import engine as j_engine  # noqa: E402


@pytest.fixture(params=[t_engine, j_engine], ids=["port", "reference"])
def eng(request):
    return request.param


def test_timeout_ordering(eng):
    env = eng.Environment()
    log = []

    def proc(delay, tag):
        yield env.timeout(delay)
        log.append((env.now, tag))

    env.process(proc(5, "b"))
    env.process(proc(1, "a"))
    env.process(proc(9, "c"))
    env.run()
    assert log == [(1.0, "a"), (5.0, "b"), (9.0, "c")]


def test_same_time_fifo(eng):
    env = eng.Environment()
    log = []

    def proc(tag):
        yield env.timeout(3)
        log.append(tag)

    for tag in "abc":
        env.process(proc(tag))
    env.run()
    assert log == list("abc")


def test_process_return_value(eng):
    env = eng.Environment()

    def inner():
        yield env.timeout(2)
        return 42

    def outer():
        value = yield env.process(inner())
        return value + 1

    proc = env.process(outer())
    assert env.run_until_process(proc) == 43
    assert env.now == 2.0


def test_event_succeed_wakes_waiter(eng):
    env = eng.Environment()
    evt = env.event()
    got = []

    def waiter():
        value = yield evt
        got.append((env.now, value))

    def trigger():
        yield env.timeout(7)
        evt.succeed("payload")

    env.process(waiter())
    env.process(trigger())
    env.run()
    assert got == [(7.0, "payload")]


def test_interrupt_resumes_with_cause(eng):
    env = eng.Environment()
    observed = []

    def victim():
        try:
            yield env.timeout(100)
        except eng.Interrupt as exc:
            observed.append((env.now, exc.cause))

    def attacker(proc):
        yield env.timeout(4)
        proc.interrupt("stop")

    victim_proc = env.process(victim())
    env.process(attacker(victim_proc))
    env.run()
    assert observed == [(4.0, "stop")]


def test_interrupt_deregisters_pending_timeout(eng):
    env = eng.Environment()
    resumed = []

    def victim():
        try:
            yield env.timeout(10)
            resumed.append("timeout")
        except eng.Interrupt:
            resumed.append("interrupt")
            yield env.timeout(100)
            resumed.append("after")

    proc = env.process(victim())

    def attacker():
        yield env.timeout(1)
        proc.interrupt()

    env.process(attacker())
    env.run()
    # the original timeout must NOT also resume the process
    assert resumed == ["interrupt", "after"]
    assert env.now == 101.0


def test_run_until_time(eng):
    env = eng.Environment()
    ticks = []

    def clock():
        while True:
            yield env.timeout(1)
            ticks.append(env.now)

    env.process(clock())
    env.run(until=5.5)
    assert ticks == [1.0, 2.0, 3.0, 4.0, 5.0]
    assert env.now == 5.5


def test_any_of(eng):
    env = eng.Environment()
    winner = []

    def race():
        result = yield env.any_of([env.timeout(3, "slow"), env.timeout(1, "fast")])
        winner.append(sorted(result.values()))

    env.process(race())
    env.run()
    assert winner == [["fast"]]
    assert env.now >= 1.0


def test_all_of(eng):
    env = eng.Environment()
    done = []

    def gather():
        yield env.all_of([env.timeout(2), env.timeout(5)])
        done.append(env.now)

    env.process(gather())
    env.run()
    assert done == [5.0]


def test_process_exception_propagates(eng):
    env = eng.Environment()

    def boom():
        yield env.timeout(1)
        raise ValueError("kaput")

    proc = env.process(boom())
    with pytest.raises(ValueError, match="kaput"):
        env.run_until_process(proc)


def test_yield_already_processed_event(eng):
    env = eng.Environment()
    evt = env.event()
    evt.succeed("early")
    got = []

    def late_waiter():
        yield env.timeout(5)
        value = yield evt  # already processed by now
        got.append((env.now, value))

    env.process(late_waiter())
    env.run()
    assert got == [(5.0, "early")]


def test_negative_delay_rejected(eng):
    env = eng.Environment()
    with pytest.raises(ValueError):
        env.timeout(-1)


def _random_workload_log(mod, seed):
    """A seeded mix of timeouts, events, interrupts and any_of races."""
    rng = np.random.default_rng(seed)
    env = mod.Environment()
    log = []
    gate = env.event()

    def worker(i):
        try:
            for _ in range(4):
                dt = float(rng.exponential(3.0))
                got = yield env.any_of([env.timeout(dt, "t"),
                                        env.timeout(2 * dt, "slow")])
                log.append((env.now, i, sorted(got.values())))
            value = yield gate
            log.append((env.now, i, value))
        except mod.Interrupt as exc:
            log.append((env.now, i, "interrupted", exc.cause))

    procs = [env.process(worker(i)) for i in range(6)]

    def chaos():
        yield env.timeout(5.0)
        procs[2].interrupt("stop")
        yield env.timeout(20.0)
        gate.succeed("open")

    env.process(chaos())
    env.run()
    return log, env.now


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_workload_same_trace(seed):
    assert _random_workload_log(t_engine, seed) == \
        _random_workload_log(j_engine, seed)
