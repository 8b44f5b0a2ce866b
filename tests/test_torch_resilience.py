"""Pilot failure domains: retry policies (backoff, classification,
quarantine), heartbeat-supervised lost-pilot recovery, and the seeded
chaos harness.

The hard invariants under test:
  * a RetryPolicy's backoff is deterministic per (task, attempt), capped,
    and served through the agent's cv wait (no polling thread);
  * every failed attempt's exception survives on the record and is
    chained (``__cause__``) into the terminal error;
  * infra failures (SlotFailure / WorkerDied / PilotLost) retry on a
    *different* pilot when the policy asks for it;
  * a poison task that kills N workers quarantines (terminal FAILED +
    QUARANTINED journal event) while the pool stays healthy;
  * ``mark_lost`` recovers queued and RUNNING work onto survivors —
    checkpointable tasks resume from their last durable snapshot;
  * a seeded chaos storm over a multi-pilot pool completes every task
    exactly once.
"""
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import (FaultInjector, ObjectRef, Pilot, PilotLost,
                              PilotPool, ResourceSpec, RetryPolicy,
                              RPEXExecutor, SlotFailure, TaskManager,
                              TaskState, WorkerDied, python_app, translate)
from repro_torch.core import PilotDescription as _PilotDescription


def PilotDescription(*args, **kw):
    """The suite's pilot descriptions on the CPU, asked for explicitly: a
    description without devices means every CUDA device, and raises
    without a card."""
    kw.setdefault("devices", [torch.device("cpu")])
    return _PilotDescription(*args, **kw)

# ----------------------------- RetryPolicy ------------------------------ #

def test_backoff_schedule_deterministic_and_capped():
    pol = RetryPolicy(backoff_base_s=0.1, backoff_factor=2.0,
                      backoff_max_s=0.5, jitter=0.2)
    a = [pol.backoff_s(k, "task.000001") for k in (1, 2, 3, 4, 5)]
    b = [pol.backoff_s(k, "task.000001") for k in (1, 2, 3, 4, 5)]
    assert a == b                           # same task+attempt -> same delay
    for k, d in enumerate(a, start=1):
        nominal = min(0.5, 0.1 * 2.0 ** (k - 1))
        assert abs(d - nominal) <= 0.2 * nominal + 1e-9
    # jitter varies across tasks, not across calls
    assert pol.backoff_s(1, "task.000002") != a[0]
    assert RetryPolicy(backoff_base_s=0.0).backoff_s(3) == 0.0


def test_retry_policy_threads_through_decorator_and_translator():
    pol = RetryPolicy(max_retries=5, backoff_base_s=0.0)

    @python_app(retry_policy=pol)
    def appfn():
        return 1

    fn = appfn.__wrapped_app__
    t = translate(fn, (), {}, fn.__resources__, retry_policy=pol)
    assert t.retry_policy is pol
    assert t.max_retries == 5               # policy supersedes bare count


@pytest.mark.timeout(60)
def test_backoff_delays_requeue_and_attempts_chain_into_success_history():
    """Two failures then success: the agent parks the retry on its delayed
    heap (cv-timed, no poll), and both attempt errors stay on the record."""
    pilot = Pilot(PilotDescription(n_slots=1, name="bk"))
    try:
        calls = []

        def flaky():
            calls.append(time.monotonic())
            if len(calls) < 3:
                raise RuntimeError(f"boom {len(calls)}")
            return "ok"

        pol = RetryPolicy(max_retries=3, backoff_base_s=0.15,
                          backoff_factor=1.0, jitter=0.0)
        t = translate(flaky, (), {}, retry_policy=pol)
        done = threading.Event()
        pilot.agent.submit(t, done_cb=lambda _t: done.set())
        assert done.wait(30)
        assert t.state == TaskState.DONE and t.result == "ok"
        assert len(calls) == 3
        # both gaps honored the configured backoff (minus scheduling slack)
        assert calls[1] - calls[0] >= 0.13
        assert calls[2] - calls[1] >= 0.13
        assert [str(e) for e in t.attempt_errors] == ["boom 1", "boom 2"]
    finally:
        pilot.close()


@pytest.mark.timeout(60)
def test_terminal_failure_chains_attempt_history():
    pilot = Pilot(PilotDescription(n_slots=1))
    try:
        def always():
            raise RuntimeError("attempt")

        pol = RetryPolicy(max_retries=2, backoff_base_s=0.0)
        t = translate(always, (), {}, retry_policy=pol)
        done = threading.Event()
        pilot.agent.submit(t, done_cb=lambda _t: done.set())
        assert done.wait(30)
        assert t.state == TaskState.FAILED
        # final error <- attempt 2 <- attempt 1 via __cause__
        chain = []
        e = t.error
        while e is not None:
            chain.append(str(e))
            e = e.__cause__
        assert chain == ["attempt"] * 3
        # the journal record carries the attempt history too
        assert len(pilot.store.tasks[t.uid]["attempt_errors"]) == 2
    finally:
        pilot.close()


@pytest.mark.timeout(60)
def test_fatal_exception_short_circuits_retries():
    pilot = Pilot(PilotDescription(n_slots=1))
    try:
        calls = []

        def fatal():
            calls.append(1)
            raise ValueError("unretryable")

        pol = RetryPolicy(max_retries=5, backoff_base_s=0.0,
                          fatal_exceptions=(ValueError,))
        t = translate(fatal, (), {}, retry_policy=pol)
        done = threading.Event()
        pilot.agent.submit(t, done_cb=lambda _t: done.set())
        assert done.wait(30)
        assert t.state == TaskState.FAILED and len(calls) == 1
        assert isinstance(t.error, ValueError)
    finally:
        pilot.close()


@pytest.mark.timeout(120)
def test_infra_failure_retries_on_a_different_pilot():
    """A SlotFailure (infra) retry re-places on the sibling pilot, not the
    one whose slot just failed — visible as STOLEN(reason=retry)."""
    pool = PilotPool([PilotDescription(n_slots=1, name="ia"),
                      PilotDescription(n_slots=1, name="ib")], steal=False)
    tmgr = TaskManager(pool)
    try:
        release = threading.Event()
        pol = RetryPolicy(max_retries=2, backoff_base_s=0.0,
                          retry_different_pilot=True)
        t = translate(lambda: release.wait(10) and "done" or "done", (), {},
                      retry_policy=pol)
        tmgr.submit(t)
        src = pool.by_uid(t.pilot_uid)
        deadline = time.monotonic() + 10
        while t.state != TaskState.RUNNING:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        src.agent.inject_slot_failure(list(t.slot_ids))
        release.set()
        assert tmgr.wait(timeout=30)
        assert t.state == TaskState.DONE
        assert t.pilot_uid != src.uid           # re-routed, not requeued
        evs = [e for e in pool.events()
               if e["event"] == "STOLEN" and e.get("reason") == "retry"]
        assert evs and evs[0]["uid"] == t.uid and evs[0]["src"] == src.uid
        assert any(isinstance(e, SlotFailure) for e in t.attempt_errors)
    finally:
        release.set()
        tmgr = None
        pool.close()


@pytest.mark.timeout(120)
def test_quarantine_stops_worker_killing_task():
    """A poison task that SIGKILLs its worker on every attempt quarantines
    after N worker deaths — terminal FAILED + QUARANTINED event — instead
    of grinding through its whole retry budget, and the pilot keeps
    serving healthy work afterwards."""
    pilot = Pilot(PilotDescription(n_slots=1, transport="proc", name="qz"))
    try:
        def poison():
            os.kill(os.getpid(), signal.SIGKILL)

        pol = RetryPolicy(max_retries=10, backoff_base_s=0.0,
                          retry_different_pilot=False, quarantine_after=2)
        t = translate(poison, (), {}, retry_policy=pol)
        done = threading.Event()
        pilot.agent.submit(t, done_cb=lambda _t: done.set())
        assert done.wait(60)
        assert t.state == TaskState.FAILED
        assert t.quarantined and t.worker_deaths == 2
        assert isinstance(t.error, WorkerDied)
        causes = []
        e = t.error.__cause__
        while e is not None:
            causes.append(e)
            e = e.__cause__
        assert any(isinstance(c, WorkerDied) for c in causes)  # attempt 1
        evs = [e for e in pilot.store.events_snapshot()
               if e.get("event") == "QUARANTINED"]
        assert len(evs) == 1 and evs[0]["uid"] == t.uid
        assert evs[0]["worker_deaths"] == 2

        # the pool replaced the dead workers: healthy work still runs
        t2 = translate(lambda: 42, (), {})
        done2 = threading.Event()
        pilot.agent.submit(t2, done_cb=lambda _t: done2.set())
        assert done2.wait(60) and t2.result == 42
    finally:
        pilot.close()


# --------------------------- lost-pilot recovery -------------------------- #

def _resumable(n, step_s, log, lock, ckpt=None):
    start = 0
    got = ckpt.restore()
    if got is not None:
        start = got[0] + 1
    for step in range(start, n):
        time.sleep(step_s)
        with lock:
            log.append(step)
        ckpt.save(step, step)
    return {"start": start}


@pytest.mark.timeout(120)
def test_mark_lost_recovers_queued_and_running_work():
    """mark_lost on a loaded pilot: queued tasks re-route to the survivor
    (STOLEN reason=pilot-lost), a RUNNING checkpointable task re-adopts
    its snapshot and resumes at step > 0, a RUNNING non-checkpointable
    task burns a retry and reruns — every future resolves and PILOT_LOST
    is journaled on the lost pilot."""
    pool = PilotPool([PilotDescription(n_slots=2, name="la",
                                       straggler_factor=1e9),
                      PilotDescription(n_slots=2, name="lb",
                                       straggler_factor=1e9)], steal=False)
    tmgr = TaskManager(pool)
    try:
        a, b = pool.pilots
        lock, log = threading.Lock(), []
        ck = translate(_resumable, (8, 0.1, log, lock), {},
                       ResourceSpec(checkpointable=True))
        plain = translate(lambda: time.sleep(1.0) or "rerun", (), {},
                          retry_policy=RetryPolicy(max_retries=1,
                                                   backoff_base_s=0.0))
        queued = [translate(lambda i=i: i, (), {}) for i in range(4)]
        for t in [ck, plain] + queued:
            tmgr._bind(t, pilot=a)
            with tmgr._cv:
                tmgr._outstanding += 1
            t.transition(TaskState.TRANSLATED, a.store)
        results = {}

        def mk_cb(t):
            return lambda rec, _u=t.uid: results.__setitem__(_u, rec)

        # occupy both of a's slots (ck=1 slot, plain=1 slot); the rest queue
        a.agent.submit(ck, done_cb=mk_cb(ck))
        a.agent.submit(plain, done_cb=mk_cb(plain))
        for t in queued:
            a.agent.submit(t, done_cb=mk_cb(t))
        deadline = time.monotonic() + 15
        while a.ckpt.step(ck.ckpt_key) is None:
            assert time.monotonic() < deadline, "no checkpoint saved"
            time.sleep(0.02)

        assert pool.mark_lost(a, reason="test")
        assert a not in pool.pilots and a in pool.retired
        assert pool.take_lost() == [a.uid]

        deadline = time.monotonic() + 60
        while len(results) < 6 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert len(results) == 6
        assert all(r.state == TaskState.DONE for r in results.values())
        # the checkpointable task resumed on b from its saved step; the
        # boundary step may run twice (the zombie's last save can race
        # the snapshot adoption — crash recovery is at-least-once there,
        # unlike cooperative preemption), but nothing is lost
        assert results[ck.uid].result["start"] > 0
        assert results[ck.uid].pilot_uid == b.uid
        assert set(log) == set(range(8))
        # the plain task burned a retry and carries the PilotLost evidence
        assert results[plain.uid].retries == 1
        assert any(isinstance(e, PilotLost)
                   for e in results[plain.uid].attempt_errors)

        evs = pool.events()
        lost = [e for e in evs if e["event"] == "PILOT_LOST"]
        assert len(lost) == 1 and lost[0]["pilot"] == a.uid
        assert lost[0]["reason"] == "test"
        assert lost[0]["queued"] == 4 and lost[0]["running"] == 2
        moved = [e for e in evs if e["event"] == "STOLEN"
                 and e.get("reason") == "pilot-lost"]
        assert {e["uid"] for e in moved} >= {t.uid for t in queued}
    finally:
        pool.close()


@pytest.mark.timeout(120)
def test_pilot_loss_rehosts_live_objects():
    """A lost pilot's published results move to a survivor: existing refs
    keep resolving without a cross-pilot charge against the dead owner,
    and the hand-off is journaled (docs/dataplane.md)."""
    pool = PilotPool([PilotDescription(n_slots=2, name="oa"),
                      PilotDescription(n_slots=2, name="ob")], steal=False)
    tmgr = TaskManager(pool)
    try:
        a, b = pool.pilots
        t = translate(lambda: np.ones(32_768, dtype=np.float64), (), {})
        tmgr._bind(t, pilot=a)
        with tmgr._cv:
            tmgr._outstanding += 1
        t.transition(TaskState.TRANSLATED, a.store)
        done = threading.Event()
        a.agent.submit(t, done_cb=lambda _t: done.set())
        assert done.wait(30)
        ref = t.result
        assert isinstance(ref, ObjectRef) and ref.pilot_uid == a.uid

        assert pool.mark_lost(a, reason="test")
        e = pool.objectstore.entry(ref.oid)
        assert e.owner == b.uid
        assert pool.objectstore.stats()["rehosted"] >= 1
        got = ref.deref(pilot_uid=b.uid)
        assert float(got.sum()) == 32_768.0
        # re-homed: the survivor's read is local, not a transfer
        assert pool.objectstore.stats()["bytes_moved"] == 0
        evs = pool.events()
        re_ev = [ev for ev in evs if ev["event"] == "OBJECTS_REHOSTED"]
        assert re_ev and re_ev[0]["src"] == a.uid
        assert re_ev[0]["objects"] >= 1
    finally:
        pool.close()


@pytest.mark.timeout(120)
def test_nonretryable_running_task_fails_visibly_on_pilot_loss():
    pool = PilotPool([PilotDescription(n_slots=1, name="fa"),
                      PilotDescription(n_slots=1, name="fb")], steal=False)
    try:
        a = pool.pilots[0]
        gate = threading.Event()
        t = translate(lambda: gate.wait(10), (), {})     # max_retries=0
        t.transition(TaskState.TRANSLATED, a.store)
        box = {}
        done = threading.Event()
        a.agent.submit(t, done_cb=lambda rec: (box.update(r=rec),
                                               done.set()))
        deadline = time.monotonic() + 10
        while t.state != TaskState.RUNNING:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert pool.mark_lost(a)
        assert done.wait(30)
        rec = box["r"]
        assert rec.state == TaskState.FAILED
        assert isinstance(rec.error, PilotLost)
    finally:
        gate.set()
        pool.close()


@pytest.mark.timeout(120)
def test_heartbeat_monitor_declares_crashed_pilot_lost():
    """An injected crash silences the agent's loop; the pool's health
    monitor notices within the timeout and recovers the queued work onto
    the survivor without any explicit mark_lost call."""
    pool = PilotPool([PilotDescription(n_slots=1, name="ha"),
                      PilotDescription(n_slots=1, name="hb")],
                     steal=False, heartbeat_timeout_s=0.6)
    tmgr = TaskManager(pool)
    try:
        a, b = pool.pilots
        gate = threading.Event()
        blocker = translate(lambda: gate.wait(10), (), {})
        queued = [translate(lambda i=i: i * 10, (), {}) for i in range(3)]
        results = {}
        for t in [blocker] + queued:
            tmgr._bind(t, pilot=a)
            with tmgr._cv:
                tmgr._outstanding += 1
            t.transition(TaskState.TRANSLATED, a.store)
            a.agent.submit(
                t, done_cb=lambda rec, _u=t.uid: results.__setitem__(_u, rec))
        time.sleep(0.05)
        a.agent.inject_crash()

        deadline = time.monotonic() + 30
        while a not in pool.retired and time.monotonic() < deadline:
            time.sleep(0.02)
        assert a in pool.retired, "health monitor never declared the loss"
        lost = [e for e in pool.events() if e["event"] == "PILOT_LOST"]
        assert lost and lost[0]["reason"] == "crash"

        deadline = time.monotonic() + 30
        while (len([u for u in results if u != blocker.uid]) < 3
               and time.monotonic() < deadline):
            time.sleep(0.05)
        got = {u: r for u, r in results.items() if u != blocker.uid}
        assert len(got) == 3
        assert all(r.state == TaskState.DONE and r.pilot_uid == b.uid
                   for r in got.values())
    finally:
        gate.set()
        pool.close()


@pytest.mark.timeout(60)
def test_shutdown_reports_stranded_tasks():
    pilot = Pilot(PilotDescription(n_slots=1, name="st"))
    gate = threading.Event()
    try:
        running = translate(lambda: gate.wait(10), (), {})
        queued = translate(lambda: "q", (), {})
        pilot.agent.submit(running)
        time.sleep(0.05)
        pilot.agent.submit(queued)
        stranded = pilot.agent.shutdown(wait=True, timeout=0.2)
        assert sorted(stranded) == sorted([running.uid, queued.uid])
        evs = [e for e in pilot.store.events_snapshot()
               if e.get("event") == "SHUTDOWN_STRANDED"]
        assert evs and evs[0]["count"] == 2
    finally:
        gate.set()
        pilot.close()


# ------------------------------ chaos soak ------------------------------- #

@pytest.mark.timeout(300)
def test_chaos_soak_exactly_once_completion():
    """Seeded storm (pilot crash + worker kills + slot failures) over a
    3-pilot pool under a 200-task burst: every task completes exactly
    once, and the injected pilot loss is visible in the event stream."""
    pool = PilotPool(
        [PilotDescription(n_slots=4, name="s0", straggler_factor=1e9),
         PilotDescription(n_slots=4, name="s1", straggler_factor=1e9,
                          transport="proc"),
         PilotDescription(n_slots=4, name="s2", straggler_factor=1e9)],
        heartbeat_timeout_s=0.8)
    tmgr = TaskManager(pool)
    inj = FaultInjector(pool, seed=7)
    inj.storm(duration_s=2.5, pilot_crashes=1, worker_kills=2,
              slot_failures=2, task_hangs=0, warmup_s=0.4)
    try:
        pol = RetryPolicy(max_retries=6, backoff_base_s=0.01,
                          backoff_max_s=0.1, quarantine_after=None)
        completions = []   # the record arriving at the cb may be a same-
        lock = threading.Lock()   # uid recovery clone: read results here

        def cb(rec):
            with lock:
                completions.append((rec.uid, rec.state, rec.result))

        tasks = [translate(lambda i=i: time.sleep(0.04) or i * i, (), {},
                           retry_policy=pol)
                 for i in range(200)]
        inj.start()
        tmgr.submit_bulk(tasks, done_cb=cb)
        assert tmgr.wait(timeout=180), "soak never drained"
        inj.stop()

        assert len(completions) == 200
        assert len({u for u, _, _ in completions}) == 200   # exactly once
        assert all(s == TaskState.DONE for _, s, _ in completions)
        want = {t.uid: i * i for i, t in enumerate(tasks)}
        for u, _, res in completions:
            assert res == want[u]
        assert inj.events, "storm injected nothing"
        if any(e["kind"] == "pilot-crash" and "pilot" in e
               for e in inj.events):
            assert any(e["event"] == "PILOT_LOST" for e in pool.events())
    finally:
        inj.stop()
        pool.close()


def test_fault_injector_schedule_is_deterministic():
    pool = PilotPool([PilotDescription(n_slots=1, name="d0")])
    try:
        a = FaultInjector(pool, seed=42)
        a.storm(duration_s=5.0, pilot_crashes=1, worker_kills=3,
                slot_failures=2, task_hangs=1)
        b = FaultInjector(pool, seed=42)
        b.storm(duration_s=5.0, pilot_crashes=1, worker_kills=3,
                slot_failures=2, task_hangs=1)
        assert [(at, lbl) for at, _, _, lbl in a._schedule] == \
               [(at, lbl) for at, _, _, lbl in b._schedule]
        c = FaultInjector(pool, seed=43)
        c.storm(duration_s=5.0, pilot_crashes=1, worker_kills=3,
                slot_failures=2, task_hangs=1)
        assert [(at, lbl) for at, _, _, lbl in a._schedule] != \
               [(at, lbl) for at, _, _, lbl in c._schedule]
    finally:
        pool.close()
