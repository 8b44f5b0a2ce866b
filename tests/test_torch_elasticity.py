"""Inter-pilot work stealing + elastic PilotPool: behaviour, fault
injection, and journal-replay correctness when task->pilot binding is no
longer immutable.

The hard invariants under test:
  * a task racing a steal against a dispatch runs exactly once and its
    completion callback fires exactly once;
  * sticky tasks and straggler replicas never migrate;
  * a draining pilot retires even when its slots fail mid-drain, and its
    orphaned tasks finish elsewhere;
  * an unroutable task during autoscale fails its future cleanly;
  * a restarted run resolves completed stolen tasks from the journal of
    the pilot that actually ran them (STOLEN + PILOT_RETIRE in stream).
"""
import json
import threading
import time

import pytest
import torch

from repro_torch.core import (EVENTS, DataFlowKernel, LocalityAware, Pilot,
                              PilotPool, PoolScaler,
                              ResourceSpec, RetryPolicy, RPEXExecutor,
                              ScalerConfig, TaskState,
                              overhead_from_events, python_app, translate)
from repro_torch.core import PilotDescription as _PilotDescription


def PilotDescription(*args, **kw):
    """The suite's pilot descriptions on the CPU, asked for explicitly: a
    description without devices means every CUDA device, and raises
    without a card."""
    kw.setdefault("devices", [torch.device("cpu")])
    return _PilotDescription(*args, **kw)


def _occupy(tmgr, pilot, n, gate):
    """Pin n gated blocker tasks directly onto one pilot (bypassing
    least-loaded routing) so tests can shape load deterministically."""
    def blocker():
        gate.wait(15)
        return "blk"
    tasks = [translate(blocker, (), {}) for _ in range(n)]
    for t in tasks:
        tmgr._bind(t, pilot=pilot)
        with tmgr._cv:
            tmgr._outstanding += 1
        t.transition(TaskState.TRANSLATED, pilot.store)
        pilot.agent.submit(t, done_cb=tmgr._completion_cb(None))
    return tasks


# ----------------------------- work stealing ---------------------------- #

def test_idle_pilot_steals_queued_work():
    """A pilot going idle pulls queued-but-not-dispatched tasks off the
    loaded sibling: pilot_uid is re-stamped, a STOLEN event is emitted,
    and every future resolves."""
    rpex = RPEXExecutor([PilotDescription(n_slots=2, name="a"),
                         PilotDescription(n_slots=2, name="b")])
    try:
        a, b = rpex.pool.pilots
        gate = threading.Event()
        _occupy(rpex.tmgr, b, 12, gate)         # b is the "loaded" pilot

        work = [translate(lambda d=d: time.sleep(d) or d, (), {})
                for d in [0.05] * 8]
        for t in work:
            rpex.tmgr.submit(t)                 # all route to a (lower load)
        assert {t.pilot_uid for t in work} == {a.uid}

        time.sleep(0.05)                        # a starts 2, queues the rest
        gate.set()                              # b drains -> hungry -> steals
        assert rpex.tmgr.wait(timeout=15)

        stolen_evs = [e for e in rpex.pool.events() if e["event"] == "STOLEN"]
        assert stolen_evs, "no STOLEN event emitted"
        stolen_uids = {e["uid"] for e in stolen_evs}
        moved = [t for t in work if t.uid in stolen_uids]
        assert moved, "no task actually migrated"
        for t in moved:
            assert t.pilot_uid == b.uid         # binding re-stamped
            assert t.state == TaskState.DONE
        for e in stolen_evs:
            assert e["src"] == a.uid and e["dst"] == b.uid
    finally:
        gate.set()
        rpex.shutdown()


def test_sticky_stamp_threads_through_decorators_and_dfk():
    """@python_app(sticky=True) and the DFK's per-invocation override both
    reach the translated TaskRecord the steal predicate inspects."""
    @python_app(sticky=True)
    def pinned():
        return 1

    fn = pinned.__wrapped_app__
    assert fn.__resources__.sticky
    assert translate(fn, (), {}, fn.__resources__).sticky

    rpex = RPEXExecutor(PilotDescription(n_slots=2))
    try:
        with DataFlowKernel(executors={"rpex": rpex}) as dfk:
            f1 = pinned()
            f2 = dfk.submit(fn, (), sticky=False)     # invocation override
            assert f1.result(timeout=10) == 1
            assert f2.result(timeout=10) == 1
        assert f1.task.sticky and not f2.task.sticky
    finally:
        rpex.shutdown()


def test_sticky_tasks_are_never_stolen():
    pilot = Pilot(PilotDescription(n_slots=1, name="v"))
    try:
        gate = threading.Event()
        blocker = translate(lambda: gate.wait(10), (), {})
        pilot.agent.submit(blocker)             # occupies the only slot
        time.sleep(0.05)

        sticky = translate(lambda: "s", (), {}, ResourceSpec(sticky=True))
        normal = translate(lambda: "n", (), {})
        assert sticky.sticky and not normal.sticky
        pilot.agent.submit(sticky)
        pilot.agent.submit(normal)

        batch = pilot.agent.steal(pred=lambda t: True)
        assert [t.uid for t, _ in batch] == [normal.uid]
        assert pilot.agent.queued_demand() == 1   # sticky still queued
        # the drain path (pred=None) does take sticky tasks — a dying
        # pilot cannot honor stickiness
        batch2 = pilot.agent.steal()
        assert [t.uid for t, _ in batch2] == [sticky.uid]
        gate.set()
        assert pilot.agent.wait_idle(timeout=10)
    finally:
        gate.set()
        pilot.close()


def test_steal_racing_dispatch_runs_each_task_exactly_once():
    """Fault-injection: hammer request_work() from two threads while the
    victim's scheduler loop dispatches — every task executes exactly once
    and every completion callback fires exactly once."""
    # huge straggler_factor: sub-ms tasks under hammer load would
    # otherwise trip the p95 replica deadline and legitimately run twice
    pool = PilotPool([PilotDescription(n_slots=1, name="victim",
                                       straggler_factor=1e9),
                      PilotDescription(n_slots=1, name="thief",
                                       straggler_factor=1e9)])
    try:
        victim, thief = pool.pilots
        runs = {}
        dones = {}
        lock = threading.Lock()

        def body(uid):
            with lock:
                runs[uid] = runs.get(uid, 0) + 1

        n = 150
        tasks = [translate(body, (f"u{i}",), {}) for i in range(n)]

        def on_done(t):
            with lock:
                dones[t.uid] = dones.get(t.uid, 0) + 1

        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                pool.request_work(thief)

        hs = [threading.Thread(target=hammer) for _ in range(2)]
        for h in hs:
            h.start()
        for i, t in enumerate(tasks):
            t.pilot_uid = victim.uid
            victim.agent.submit(t, done_cb=on_done)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if victim.agent.wait_idle(0.2) and thief.agent.wait_idle(0.2):
                break
        stop.set()
        for h in hs:
            h.join(timeout=5)

        assert set(runs) == {f"u{i}" for i in range(n)}
        assert set(runs.values()) == {1}, "a task ran twice or never"
        assert len(dones) == n and set(dones.values()) == {1}, \
            "a completion callback was lost or fired twice"
        assert all(t.state == TaskState.DONE for t in tasks)
    finally:
        pool.close()


def test_affinity_steal_racing_dispatch_runs_each_task_exactly_once():
    """Fault-injection for the affinity-aware steal gate: hammer
    request_work() under a LocalityAware policy while the victim
    dispatches a mixed affine/non-affine workload.  The gate flips
    per-task between eligible and blocked as the victim's backlog
    drains, racing the scheduler's allocation — every task must still
    run exactly once and deliver its callback exactly once, wherever it
    lands."""
    pool = PilotPool([PilotDescription(n_slots=1, name="victim",
                                       straggler_factor=1e9),
                      PilotDescription(n_slots=1, name="thief",
                                       straggler_factor=1e9)],
                     policy=LocalityAware(locality_weight=0.5))
    try:
        victim, thief = pool.pilots
        runs = {}
        dones = {}
        lock = threading.Lock()

        def body(uid):
            with lock:
                runs[uid] = runs.get(uid, 0) + 1

        n = 150
        tasks = []
        for i in range(n):
            t = translate(body, (f"u{i}",), {})
            if i % 3 == 0:
                t.affinity = (victim.uid,)    # gate weighs these
            elif i % 3 == 1:
                t.affinity = (thief.uid,)     # always eligible
            tasks.append(t)

        def on_done(t):
            with lock:
                dones[t.uid] = dones.get(t.uid, 0) + 1

        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                pool.request_work(thief)

        hs = [threading.Thread(target=hammer) for _ in range(2)]
        for h in hs:
            h.start()
        for t in tasks:
            t.pilot_uid = victim.uid
            victim.agent.submit(t, done_cb=on_done)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if victim.agent.wait_idle(0.2) and thief.agent.wait_idle(0.2):
                break
        stop.set()
        for h in hs:
            h.join(timeout=5)

        assert set(runs) == {f"u{i}" for i in range(n)}
        assert set(runs.values()) == {1}, "a task ran twice or never"
        assert len(dones) == n and set(dones.values()) == {1}, \
            "a completion callback was lost or fired twice"
        assert all(t.state == TaskState.DONE for t in tasks)
        # the gate actually bit both ways: something migrated, and
        # thief-affine work migrated at least as readily as victim-affine
        stolen = [e for e in pool.events() if e["event"] == "STOLEN"]
        assert stolen, "no steal ever passed the affinity gate"
    finally:
        pool.close()


@pytest.mark.slow
def test_randomized_steal_fault_churn():
    """Property-style fault injection: a seeded random interleaving of
    submissions, steals, slot failures and grows across a two-pilot pool
    never loses or double-fires a completion callback, and every task
    reaches a terminal state.  (Execution counts may legitimately exceed
    one for failed-and-retried tasks; callback delivery may not.)"""
    import random
    rng = random.Random(0xBA1A)
    pool = PilotPool([PilotDescription(n_slots=2, name="p0",
                                       straggler_factor=1e9),
                      PilotDescription(n_slots=2, name="p1",
                                       straggler_factor=1e9)])
    try:
        runs, dones = {}, {}
        lock = threading.Lock()
        tasks = []

        def body(uid):
            with lock:
                runs[uid] = runs.get(uid, 0) + 1

        def on_done(t):
            with lock:
                dones[t.uid] = dones.get(t.uid, 0) + 1

        for step in range(300):
            op = rng.random()
            p = pool.pilots[rng.randrange(2)]
            if op < 0.55:
                t = translate(body, (f"u{len(tasks)}",), {})
                t.max_retries = 2
                t.pilot_uid = p.uid
                tasks.append(t)
                p.agent.submit(t, done_cb=on_done)
            elif op < 0.80:
                pool.request_work(p)
            elif op < 0.90:
                p.agent.inject_slot_failure([rng.randrange(8)])
                p.grow(1)               # keep capacity alive under faults
            else:
                time.sleep(0.002)

        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if all(p.agent.wait_idle(0.25) for p in pool.pilots):
                break
        assert all(p.agent.wait_idle(0) for p in pool.pilots), \
            "runtime failed to drain after churn"

        assert len(dones) == len(tasks), "a completion callback was lost"
        assert set(dones.values()) == {1}, "a callback fired twice"
        from repro_torch.core import TaskState as TS
        for t in tasks:
            assert t.state in (TS.DONE, TS.FAILED)
            if t.state == TS.DONE:
                assert runs.get(t.args[0], 0) >= 1
        for p in pool.pilots:
            s = p.scheduler
            assert s.n_free + s.n_busy == s.capacity
    finally:
        pool.close()


# ------------------------------- drain ---------------------------------- #

def test_slot_failure_during_drain_still_retires():
    """inject_slot_failure mid-drain: the running task fails, its retry
    requeues with no capacity left, the drain sweep hands it to the pool,
    and the pilot still retires (PILOT_RETIRE, drained pool survives)."""
    pool = PilotPool([PilotDescription(n_slots=2, name="dying"),
                      PilotDescription(n_slots=2, name="survivor")])
    try:
        dying, survivor = pool.pilots
        gate = threading.Event()
        results = []

        def work():
            gate.wait(10)
            return "ok"

        t = translate(work, (), {})
        t.max_retries = 1
        t.pilot_uid = dying.uid
        dying.agent.submit(t, done_cb=results.append)
        time.sleep(0.1)                          # task is RUNNING on dying

        retire_done = []
        th = threading.Thread(
            target=lambda: retire_done.append(pool.retire(dying, timeout=10)))
        th.start()
        time.sleep(0.15)                         # drain is waiting on it
        dying.agent.inject_slot_failure([0, 1])  # kill its slots
        gate.set()                               # task observes the failure
        th.join(timeout=15)

        assert retire_done == [True]
        events = pool.events()
        assert any(e["event"] == "PILOT_RETIRE" and e["pilot"] == dying.uid
                   for e in events)
        # the retried task was orphaned out of the drain and finished on
        # the survivor
        assert survivor.agent.wait_idle(timeout=10)
        assert results and results[0].state == TaskState.DONE
        assert results[0].result == "ok"
        assert t.pilot_uid == survivor.uid
        assert any(e["event"] == "STOLEN" and e.get("reason") == "drain"
                   for e in events)
        assert dying not in pool.pilots and dying in pool.retired
    finally:
        gate.set()
        pool.close()


def test_migration_into_dying_pilot_is_refused_and_replaced():
    """A steal/migration racing a retire: the dying agent refuses the
    submission (instead of heaping a task it will never run) and the pool
    re-places the task on a surviving pilot — the future never hangs."""
    pool = PilotPool([PilotDescription(n_slots=2, name="alive"),
                      PilotDescription(n_slots=2, name="dying")])
    try:
        alive, dying = pool.pilots
        # simulate the race window: dying has passed its drain barrier but
        # the in-flight request_work still holds it as the destination
        dying.draining = True
        dying.agent.stop_accepting()

        done = []
        t = translate(lambda: "ok", (), {})
        pool._migrate(t, alive, dying, done.append, reason="steal")
        assert alive.agent.wait_idle(timeout=10)
        assert done and done[0].state == TaskState.DONE
        assert t.pilot_uid == alive.uid
        assert t.result == "ok"
    finally:
        pool.close()


def test_oversized_orphan_prefers_pilot_that_fits():
    """retire() re-places a drained orphan on a pilot whose capacity can
    actually fit it, not just any kind-compatible pilot it would wait on
    forever."""
    pool = PilotPool([PilotDescription(n_slots=4, name="dying"),
                      PilotDescription(n_slots=2, name="small"),
                      PilotDescription(n_slots=4, name="big")])
    try:
        dying, small, big = pool.pilots
        gate = threading.Event()
        blocker = translate(lambda: gate.wait(10), (), {},
                            ResourceSpec(slots=4))
        dying.agent.submit(blocker)          # holds all 4 slots
        time.sleep(0.05)
        done = []
        wide = translate(lambda: "wide", (), {}, ResourceSpec(slots=4))
        wide.pilot_uid = dying.uid
        dying.agent.submit(wide, done_cb=done.append)  # queued, stealable

        # make small look least-loaded-but-unfit; retire must skip it
        retired = []
        th = threading.Thread(
            target=lambda: retired.append(pool.retire(dying, timeout=10)))
        th.start()
        time.sleep(0.1)
        gate.set()
        th.join(timeout=15)
        assert retired == [True]
        assert big.agent.wait_idle(timeout=10)
        assert done and done[0].state == TaskState.DONE
        assert wide.pilot_uid == big.uid, \
            "oversized orphan parked on a pilot that can never fit it"
    finally:
        gate.set()
        pool.close()


# ------------------------------ autoscale -------------------------------- #

def test_scaler_spawns_and_retires_pilots():
    """Queue wait above threshold spawns a pilot from the template
    (PILOT_START), stealing moves backlog (STOLEN), idleness retires it
    (PILOT_RETIRE) — the full elastic cycle, visible in the events."""
    cfg = ScalerConfig(template=PilotDescription(n_slots=2, name="elastic"),
                       min_pilots=1, max_pilots=3, scale_up_wait_s=0.1,
                       scale_down_idle_s=0.3, spawn_cooldown_s=0.15,
                       interval_s=0.05)
    rpex = RPEXExecutor(PilotDescription(n_slots=2, name="seed"), scaler=cfg)
    try:
        tasks = [translate(lambda: time.sleep(0.15), (), {})
                 for _ in range(12)]
        rpex.tmgr.submit_bulk(tasks)
        assert rpex.tmgr.wait(timeout=30)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if any(e["event"] == "PILOT_RETIRE" for e in rpex.pool.events()):
                break
            time.sleep(0.05)
        kinds = {e["event"] for e in rpex.pool.events()}
        assert {"PILOT_START", "STOLEN", "PILOT_RETIRE"} <= kinds
        acts = [d["action"] for d in rpex.scaler.decisions]
        assert "scale_up" in acts and "retire" in acts
        assert "error" not in acts
        # the seed pilot (user-configured) is never retired
        assert rpex.pool.pilots[0].desc.name == "seed"
        # utilization spans the changed pilot set (seed + retired elastics)
        assert len(rpex.utilization()) >= 2
        assert all(t.state == TaskState.DONE for t in tasks)
    finally:
        rpex.shutdown()


def test_grow_shrink_events_journal_resize():
    """In-place elastic resize is auditable: ``grow``/``shrink`` journal
    GROW/SHRINK events carrying the pilot uid and delta, and capacity
    tracks the event stream (consumer side of the event protocol — the
    static analyzer flags emitted-but-never-consumed names)."""
    pilot = Pilot(PilotDescription(n_slots=2, name="elastic"))
    try:
        pilot.grow(3)
        assert pilot.n_slots == 5
        pilot.shrink(2)
        assert pilot.n_slots == 3
        evs = pilot.store.events_snapshot()
        grows = [e for e in evs if e["event"] == EVENTS.GROW]
        shrinks = [e for e in evs if e["event"] == EVENTS.SHRINK]
        assert [(e["pilot"], e["n"]) for e in grows] == [(pilot.uid, 3)]
        assert [(e["pilot"], e["n"]) for e in shrinks] == [(pilot.uid, 2)]
    finally:
        pilot.close()


def test_scaler_picks_template_matching_starving_kinds():
    """Multi-template scaling: with a queue starving on one resource
    kind, scale-up spawns the template whose ``kinds`` cover that demand
    — not whichever template is listed first."""
    cfg = ScalerConfig(
        templates=[PilotDescription(n_slots=2, kinds=("python", "bash"),
                                    name="cpu-t"),
                   PilotDescription(n_slots=2, kinds=("gpu",),
                                    name="gpu-t")],
        min_pilots=1, max_pilots=2, scale_up_wait_s=0.1,
        spawn_cooldown_s=0.1, scale_down_idle_s=60.0, interval_s=0.05)
    # the seed accepts everything but has one slot: a burst of gpu-kind
    # tasks backs up behind it and starves
    rpex = RPEXExecutor(PilotDescription(n_slots=1, name="seed"),
                        scaler=cfg)
    try:
        tasks = [translate(lambda: time.sleep(0.1), (), {},
                           ResourceSpec(res_kind="gpu"))
                 for _ in range(10)]
        for t in tasks:
            rpex.tmgr.submit(t)
        assert rpex.tmgr.wait(timeout=30)
        ups = [d for d in rpex.scaler.decisions
               if d["action"] == "scale_up"]
        assert ups, "scaler never spawned under a starving queue"
        assert ups[0]["template"] == "gpu-t"
        assert ups[0]["kinds"] == ["gpu"]
        spawned = [p for p in rpex.pool.all_pilots()
                   if p.desc.kinds == ("gpu",)]
        assert spawned, "the gpu template pilot was never added"
        assert all(t.state == TaskState.DONE for t in tasks)
    finally:
        rpex.shutdown()


def test_unroutable_task_during_autoscale_fails_cleanly():
    """A task no pilot (current or template) accepts resolves FAILED via
    its callback while the scaler is live — no hang, no crash, and the
    routable workload is unaffected."""
    cfg = ScalerConfig(
        template=PilotDescription(n_slots=2, kinds=("python",), name="el"),
        max_pilots=2, scale_up_wait_s=0.1, interval_s=0.05)
    rpex = RPEXExecutor(
        PilotDescription(n_slots=2, kinds=("python",), name="seed"),
        scaler=cfg)
    try:
        good = [translate(lambda: time.sleep(0.05), (), {})
                for _ in range(8)]
        rpex.tmgr.submit_bulk(good)

        def dev_fn(mesh):
            return 1
        dev_fn.__app_kind__ = "spmd"
        bad = translate(dev_fn, (), {})
        failed = []
        rpex.tmgr.submit(bad, done_cb=failed.append)

        assert bad.state == TaskState.FAILED
        assert failed and "no pilot accepts" in repr(failed[0].error)
        assert rpex.tmgr.wait(timeout=20)       # nothing left hanging
        assert all(t.state == TaskState.DONE for t in good)
    finally:
        rpex.shutdown()


# --------------------------- journal replay ------------------------------ #

def test_journal_replay_resolves_stolen_tasks(tmp_path):
    """A task stolen to another pilot records its DONE (with the workflow
    key) in the journal of the pilot that ran it; a restarted run with the
    same run_id replays the result without re-executing, and the lookup
    works across retired pilots too."""
    j0, j1 = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    descs = lambda: [PilotDescription(n_slots=2, journal=j0, name="a"),
                     PilotDescription(n_slots=2, journal=j1, name="b")]
    calls = []

    @python_app
    def work(x):
        calls.append(x)
        return x * 7

    r1 = RPEXExecutor(descs())
    a, b = r1.pool.pilots
    gate_a, gate_b = threading.Event(), threading.Event()
    _occupy(r1.tmgr, a, 2, gate_a)      # a: both slots busy, lower load
    _occupy(r1.tmgr, b, 4, gate_b)      # b: higher load -> work routes to a
    with DataFlowKernel(executors={"rpex": r1}, run_id="steal-run"):
        f = work(6)
        time.sleep(0.1)
        assert f.task.pilot_uid == a.uid        # routed to a, queued there
        gate_b.set()                            # b drains and steals it
        assert f.result(timeout=15) == 42
        gate_a.set()
    assert f.task.pilot_uid == b.uid, "task was not stolen to b"
    assert any(e["event"] == "STOLEN" and e["uid"] == f.task.uid
               for e in r1.pool.events())
    # retire the pilot that ran it: lookup must still work (all_pilots)
    assert r1.pool.retire(b, timeout=10)
    found, result = r1.completed_result("steal-run/work:0")
    assert found and result == 42
    r1.shutdown()

    # the DONE record lives in b's journal, stamped with b's uid
    recs = [json.loads(line) for line in open(j1)]
    done = [r for r in recs if r.get("key") == "steal-run/work:0"
            and r.get("state") == "DONE"]
    assert done and done[-1]["pilot"] == b.uid
    assert done[-1]["result"] == 42

    # restart: the future resolves from the journal, work() never re-runs
    assert calls == [6]
    r2 = RPEXExecutor(descs())
    with DataFlowKernel(executors={"rpex": r2}, run_id="steal-run"):
        f2 = work(6)
        assert f2.result(timeout=10) == 42
    r2.shutdown()
    assert calls == [6], "replayed task was re-executed"


# ------------------- overhead from the event stream ---------------------- #

def test_overhead_from_events_synthetic_timeline():
    """Regression for the exp2 rp_oh_s overcount: concurrent launches
    merge into one wall-clock interval, slot-idle gaps between dependent
    tasks contribute nothing, and every retry attempt counts."""
    E = lambda uid, state, t: {"event": "STATE", "uid": uid,
                               "state": state, "t": t}
    events = [
        # a simple task: 0.1s scheduled->running
        E("a", "SCHEDULED", 0.0), E("a", "RUNNING", 0.1), E("a", "DONE", 1.0),
        # slots idle 1.0 -> 5.0 waiting on the dependency: no overhead
        E("b", "SCHEDULED", 5.0), E("b", "RUNNING", 5.2), E("b", "DONE", 6.0),
        # two concurrent launches: union is 0.5, per-task sum says 1.0
        E("c", "SCHEDULED", 10.0), E("d", "SCHEDULED", 10.0),
        E("c", "RUNNING", 10.5), E("d", "RUNNING", 10.5),
        # failed before ever RUNNING: terminal stamp closes the interval
        E("e", "SCHEDULED", 20.0), E("e", "FAILED", 20.25),
        # a retried task: both attempts contribute
        E("f", "SCHEDULED", 30.0), E("f", "RUNNING", 30.1),
        E("f", "FAILED", 31.0),
        E("f", "SCHEDULED", 40.0), E("f", "RUNNING", 40.1),
        # non-STATE noise must be ignored
        {"event": "STOLEN", "uid": "b", "t": 4.0, "src": "x", "dst": "y"},
    ]
    got = overhead_from_events(events)
    want = 0.1 + 0.2 + 0.5 + 0.25 + 0.1 + 0.1
    assert abs(got - want) < 1e-9

    # the old per-task sum overcounts the concurrent window
    old_sum = (0.1 + 0.2 + 0.5 + 0.5 + 0.1 + 0.1)
    assert old_sum > got

    assert overhead_from_events([]) == 0.0


def test_rp_overhead_accessor_live():
    """The executor-level accessor integrates the live stream and stays
    far below wall-clock for an idle-heavy dependent workload."""
    rpex = RPEXExecutor(PilotDescription(n_slots=2))
    try:
        @python_app
        def step(x):
            time.sleep(0.05)
            return x + 1

        t0 = time.monotonic()
        with DataFlowKernel(executors={"rpex": rpex}):
            f = step(step(step(0)))             # a dependent chain
            assert f.result(timeout=15) == 3
        wall = time.monotonic() - t0
        oh = rpex.rp_overhead()
        assert 0.0 <= oh < wall
        # 3 x 50ms of compute is not overhead; the recompute must not
        # charge the dependency idle time either
        assert oh < wall - 0.1
    finally:
        rpex.shutdown()


# --------------------- proc-worker fault injection ----------------------- #

def _wait_for_file(path, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            txt = path.read_text().strip()
            if txt:
                return txt
        except OSError:
            pass
        time.sleep(0.02)
    raise AssertionError(f"{path} never appeared")


def test_proc_worker_death_fails_task_and_pool_respawns(tmp_path):
    """Chaos: SIGKILL a proc-mode worker mid-task.  The in-flight task
    must FAIL visibly (WorkerDied, not a hang), its slot must come back,
    and the pool must respawn a worker for the next task."""
    import os
    import signal

    from repro_torch.core import WorkerDied

    rpex = RPEXExecutor(PilotDescription(n_slots=2, transport="proc"))
    try:
        pidfile = tmp_path / "victim.pid"

        @python_app
        def stall(pf):
            import os as _os
            import time as _time
            with open(pf, "w") as fh:
                fh.write(str(_os.getpid()))
            _time.sleep(60)            # killed long before this returns

        @python_app
        def probe():
            return "alive"

        with DataFlowKernel(executors={"rpex": rpex}):
            f = stall(str(pidfile))
            pid = int(_wait_for_file(pidfile))
            os.kill(pid, signal.SIGKILL)
            with pytest.raises(WorkerDied):
                f.result(timeout=20)   # FAILED, not hung
            assert f.task.state == TaskState.FAILED
            # slot released + lazy respawn: new work still completes
            assert probe().result(timeout=20) == "alive"
        agent = rpex.pilot.agent
        assert agent.scheduler.n_free == 2     # no leaked allocation
    finally:
        rpex.shutdown()


def test_proc_worker_death_retry_path_fires(tmp_path):
    """A task whose worker is killed retries like any other failure: the
    second attempt lands on a respawned worker and succeeds."""
    import os
    import signal

    p = Pilot(PilotDescription(n_slots=2, transport="proc"))
    try:
        flag = tmp_path / "first-attempt"
        pidfile = tmp_path / "victim.pid"

        def flaky(flagp, pidp):
            import os as _os
            import time as _time
            if not _os.path.exists(flagp):
                with open(flagp, "w") as fh:
                    fh.write("x")
                with open(pidp, "w") as fh:
                    fh.write(str(_os.getpid()))
                _time.sleep(60)        # first attempt: killed here
            return 42                  # retry: clean success

        t = translate(flaky, (str(flag), str(pidfile)), {}, max_retries=1)
        t.transition(TaskState.TRANSLATED, p.store)
        done = threading.Event()
        box = {}

        def cb(task):
            box["state"], box["result"] = task.state, task.result
            done.set()

        assert p.agent.submit(t, done_cb=cb)
        pid = int(_wait_for_file(pidfile))
        os.kill(pid, signal.SIGKILL)
        assert done.wait(30), "retry after worker death never completed"
        assert box["state"] == TaskState.DONE
        assert box["result"] == 42
        assert t.retries == 1
    finally:
        p.close()


# --------------------------- pilot failure domains ------------------------ #

@pytest.mark.timeout(120)
def test_scaler_replaces_lost_pilot_mid_burst():
    """A pilot crashing under a live burst is declared LOST by heartbeat
    supervision, its work re-routes, and the PoolScaler's replace-on-loss
    trigger restores the pool's capacity from the template — bypassing
    the spawn cooldown, since loss is not load."""
    pool = PilotPool([PilotDescription(n_slots=2, name="rla",
                                       straggler_factor=1e9),
                      PilotDescription(n_slots=2, name="rlb",
                                       straggler_factor=1e9)],
                     heartbeat_timeout_s=0.5)
    scaler = PoolScaler(pool, ScalerConfig(
        template=PilotDescription(n_slots=2, name="spare",
                                  straggler_factor=1e9),
        min_pilots=2, max_pilots=3, interval_s=0.05,
        scale_up_wait_s=1e9, scale_down_idle_s=1e9,
        spawn_cooldown_s=1e9)).start()
    from repro_torch.core import TaskManager
    tmgr = TaskManager(pool)
    try:
        a, b = pool.pilots
        pol = RetryPolicy(max_retries=4, backoff_base_s=0.0)
        results = []
        lock = threading.Lock()

        def cb(rec):
            with lock:
                results.append(rec)

        tasks = [translate(lambda i=i: time.sleep(0.05) or i, (), {},
                           retry_policy=pol) for i in range(24)]
        tmgr.submit_bulk(tasks, done_cb=cb)
        time.sleep(0.1)                       # burst in flight everywhere
        a.agent.inject_crash()
        assert tmgr.wait(timeout=60), "burst never drained after the loss"

        assert len(results) == 24
        assert all(r.state == TaskState.DONE for r in results)
        lost = [e for e in pool.events() if e["event"] == "PILOT_LOST"]
        assert lost and lost[0]["pilot"] == a.uid
        replaced = [d for d in scaler.decisions
                    if d["action"] == "replace_lost"]
        assert replaced and replaced[0]["lost"] == a.uid
        # the replacement is a live member; the lost pilot is not
        assert a not in pool.pilots
        assert any(p.desc.name.startswith("spare") for p in pool.active())
    finally:
        scaler.stop()
        pool.close()


@pytest.mark.timeout(120)
def test_checkpoint_readopted_from_lost_pilot_resumes_on_survivor():
    """A RUNNING checkpointable task on a crashed pilot re-adopts its
    last durable snapshot onto the survivor (ensure_checkpoint moves it)
    and resumes at step > 0 — the pilot died, the work did not."""
    pool = PilotPool([PilotDescription(n_slots=1, name="cka",
                                       straggler_factor=1e9),
                      PilotDescription(n_slots=1, name="ckb",
                                       straggler_factor=1e9)],
                     steal=False, heartbeat_timeout_s=0.5)
    try:
        a, b = pool.pilots

        def stepper(n, step_s, ckpt=None):
            got = ckpt.restore()
            start = got[0] + 1 if got is not None else 0
            for step in range(start, n):
                time.sleep(step_s)
                ckpt.save(step, step)
            return {"start": start}

        t = translate(stepper, (10, 0.08), {},
                      ResourceSpec(checkpointable=True))
        t.transition(TaskState.TRANSLATED, a.store)
        box = {}
        done = threading.Event()
        a.agent.submit(t, done_cb=lambda rec: (box.update(r=rec),
                                               done.set()))
        deadline = time.monotonic() + 15
        while a.ckpt.step(t.ckpt_key) is None:
            assert time.monotonic() < deadline, "no checkpoint saved"
            time.sleep(0.02)
        a.agent.inject_crash()                # heartbeat monitor takes over

        assert done.wait(60), "recovered task never completed"
        rec = box["r"]
        assert rec.state == TaskState.DONE
        assert rec.pilot_uid == b.uid         # resumed on the survivor
        assert rec.result["start"] > 0        # from the snapshot, not 0
        assert rec.retries == 0               # re-adoption costs no retry
        lost = [e for e in pool.events() if e["event"] == "PILOT_LOST"]
        assert lost and lost[0]["reason"] == "crash"
    finally:
        pool.close()
