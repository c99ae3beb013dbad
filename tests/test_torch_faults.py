"""The port's fault injector (``saturn_tpu_torch/resilience/faults.py``)
against the JAX package's: the same ``SATURN_TPU_FAULTS`` strings parse to
the same events (garbage and unknown kinds raise in both), the same seeds
draw the same schedules, a crash fires once, ``apply_due`` drives the
monitor, the watchdog timer marks and aborts, and the numeric and stall
queries answer alike (the cases of ``tests/test_resilience.py``).

Tolerances: none. Events, schedules and monitor states are compared
exactly. Every wait has a timeout of its own.
"""

import dataclasses
import math
import threading

import pytest

from saturn_tpu.resilience import faults as jfaults
from saturn_tpu.resilience import health as jhealth
from saturn_tpu_torch.resilience import faults
from saturn_tpu_torch.resilience import health

ENV_CASES = [
    "1+0.05:slice_preemption:4-7;2:trial_crash:jobA;3:straggler:0,2@4.5",
    "0:trial_crash:lr0;1+0.5:device_loss:0;2:device_return:0;3:straggler:0@4",
    "0:numeric_nan:a@3;0:loss_spike:b;1:batch_poison:a@1,5-6;2:dispatch_stall:b@0.7",
    "0:dispatch_stall:b;4:trial_crash: ;5:device_loss:1,3",
    " 2 : straggler : 1 ; ",
]


def _fields(events):
    out = []
    for e in events:
        d = dataclasses.asdict(e)
        d["value"] = "nan" if math.isnan(d["value"]) else d["value"]
        out.append(d)
    return out


@pytest.mark.parametrize("raw", ENV_CASES)
def test_env_parsing_matches_jax(monkeypatch, raw):
    monkeypatch.setenv("SATURN_TPU_FAULTS", raw)
    got, want = faults.FaultInjector.from_env(), jfaults.FaultInjector.from_env()
    assert _fields(got.schedule) == _fields(want.schedule)


def test_env_parsing_case_of_jax(monkeypatch):
    monkeypatch.setenv("SATURN_TPU_FAULTS", ENV_CASES[0])
    fi = faults.FaultInjector.from_env()
    assert [e.kind for e in fi.schedule] == [faults.FaultKind.SLICE_PREEMPTION,
                                              faults.FaultKind.TRIAL_CRASH,
                                              faults.FaultKind.STRAGGLER]
    pre, crash, strag = fi.schedule
    assert pre.devices == (4, 5, 6, 7) and pre.after_s == 0.05 and pre.mid_interval
    assert crash.task == "jobA" and not crash.mid_interval
    assert strag.devices == (0, 2) and strag.slowdown == 4.5


@pytest.mark.parametrize("raw", ["nonsense", "x:trial_crash:a", "1:device_loss:a-b",
                                 "1+zz:device_loss:0", "0:meteor_strike:0"])
def test_env_garbage_raises_in_both(monkeypatch, raw):
    monkeypatch.setenv("SATURN_TPU_FAULTS", raw)
    with pytest.raises(ValueError) as got:
        faults.FaultInjector.from_env()
    with pytest.raises(ValueError) as want:
        jfaults.FaultInjector.from_env()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("raw", [None, "", "   "])
def test_env_unset_or_blank_is_none(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("SATURN_TPU_FAULTS", raising=False)
    else:
        monkeypatch.setenv("SATURN_TPU_FAULTS", raw)
    assert faults.FaultInjector.from_env() is None and jfaults.FaultInjector.from_env() is None


def test_unknown_kind_rejected():
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.FaultEvent(0, "meteor_strike")
    assert faults.FaultKind.ALL == jfaults.FaultKind.ALL
    assert faults.FaultKind.TASK_LEVEL == jfaults.FaultKind.TASK_LEVEL


@pytest.mark.parametrize("seed,n_int,n_dev,kw", [
    (42, 20, 8, {}), (43, 20, 8, {}), (11, 4, 8, {"p_preempt": 0.6, "p_crash": 0.3}),
    (7, 30, 1, {"p_straggler": 0.5}), (3, 12, 4, {"p_preempt": 0.9, "p_straggler": 0.4}),
])
def test_seeded_schedule_matches_jax(seed, n_int, n_dev, kw):
    got = faults.seeded_schedule(seed, n_int, n_dev, **kw)
    assert _fields(got) == _fields(jfaults.seeded_schedule(seed, n_int, n_dev, **kw))
    for e in got:
        if e.kind == faults.FaultKind.SLICE_PREEMPTION:
            size = len(e.devices)
            assert size & (size - 1) == 0 and e.devices[0] % size == 0


def test_crash_fires_exactly_once():
    fi = faults.FaultInjector(schedule=[faults.FaultEvent(1, faults.FaultKind.TRIAL_CRASH,
                                                          task="a")])
    assert not fi.crashes("a", 0)  # wrong interval
    assert not fi.crashes("b", 1)  # wrong task
    assert fi.crashes("a", 1)
    assert not fi.crashes("a", 1)  # transient: consumed


def _health_script(pkg, hpkg):
    fi = pkg.FaultInjector(schedule=[
        pkg.FaultEvent(0, pkg.FaultKind.DEVICE_LOSS, devices=(3,)),
        pkg.FaultEvent(0, pkg.FaultKind.SLICE_PREEMPTION, devices=(4, 5), after_s=0.1),
        pkg.FaultEvent(1, pkg.FaultKind.DEVICE_RETURN, devices=(3,)),
        pkg.FaultEvent(1, pkg.FaultKind.STRAGGLER, devices=(6,), slowdown=4.0),
        pkg.FaultEvent(2, pkg.FaultKind.NUMERIC_NAN, task="a", step=2),
    ])
    mon = hpkg.FleetHealthMonitor(8)
    trail = [[e.kind for e in fi.apply_due(0, mon)], mon.alive_indices(),
             [e.devices for e in fi.due(0, mid_interval=True)]]
    trail += [[e.kind for e in fi.apply_due(1, mon)], mon.alive_indices(),
              mon.max_slowdown([6]), [e.kind for e in fi.apply_due(2, mon)]]
    return trail


def test_apply_due_drives_monitor():
    got = _health_script(faults, health)
    assert got == _health_script(jfaults, jhealth)
    assert got[0] == [faults.FaultKind.DEVICE_LOSS]
    assert got[1] == [0, 1, 2, 4, 5, 6, 7]
    assert got[2] == [(4, 5)]  # the mid-interval event is the watchdog's, not the poll's
    assert got[4] == list(range(8)) and got[5] == 4.0 and got[6] == []


def test_watchdog_marks_and_aborts():
    fi = faults.FaultInjector(schedule=[
        faults.FaultEvent(0, faults.FaultKind.SLICE_PREEMPTION, devices=(0, 1), after_s=0.02),
        faults.FaultEvent(0, faults.FaultKind.STRAGGLER, devices=(3,), slowdown=2.5,
                          after_s=0.01),
    ])
    mon = health.FleetHealthMonitor(4)
    abort = threading.Event()
    timers = fi.arm_watchdog(0, mon, abort)
    try:
        assert len(timers) == 2
        assert abort.wait(timeout=10.0)
        for t in timers:
            t.join(timeout=10.0)
        assert mon.alive_indices() == [2, 3] and mon.max_slowdown([3]) == 2.5
    finally:
        for t in timers:
            t.cancel()


def test_watchdog_cancelled_before_it_fires():
    fi = faults.FaultInjector(schedule=[
        faults.FaultEvent(0, faults.FaultKind.DEVICE_LOSS, devices=(0,), after_s=30.0)])
    mon = health.FleetHealthMonitor(2)
    abort = threading.Event()
    timers = fi.arm_watchdog(0, mon, abort)
    for t in timers:
        t.cancel()
        t.join(timeout=10.0)
    assert not abort.is_set() and mon.alive_indices() == [0, 1]


def _numeric_trail(pkg):
    fi = pkg.FaultInjector(schedule=[
        pkg.FaultEvent(0, pkg.FaultKind.NUMERIC_NAN, task="a", step=1),
        pkg.FaultEvent(0, pkg.FaultKind.LOSS_SPIKE, task="a", step=3),
        pkg.FaultEvent(1, pkg.FaultKind.BATCH_POISON, task="b", batches=(2, 5)),
        pkg.FaultEvent(1, pkg.FaultKind.DISPATCH_STALL, task="b", stall_s=0.7),
        pkg.FaultEvent(2, pkg.FaultKind.LOSS_SPIKE, step=0, value=3.5),
    ])
    out = []
    for interval in range(4):
        for name in ("a", "b"):
            plan = fi.numeric_plan(name, interval)
            if plan is not None:
                plan = {k: {i: ("nan" if math.isnan(v) else v) for i, v in d.items()}
                        for k, d in plan.items()}
            out.append((interval, name, plan, fi.dispatch_stall_s(name, interval)))
    return out


def test_numeric_plan_and_stall_match_jax():
    got = _numeric_trail(faults)
    assert got == _numeric_trail(jfaults)
    assert got[0] == (0, "a", {"steps": {1: "nan", 3: 1e9}, "batches": {}}, 0.0)
    # the poison holds from its interval on; the stall fires once
    assert got[3][2] == {"steps": {}, "batches": {2: "nan", 5: "nan"}} and got[3][3] == 0.7
    assert got[7][2] == {"steps": {}, "batches": {2: "nan", 5: "nan"}} and got[7][3] == 0.0
