"""Task checkpointing + cooperative preemption: the CheckpointStore's
journal/payload/GC/compaction behavior, checkpoint-resumed straggler
replicas, preempt-and-migrate of RUNNING tasks, partial restarts, and the
straggler-path bugfixes that ride along:

  * `_deadline` p95 over the *recent* durations (it used to sort the
    whole deque then slice, taking the 100 largest samples — the deadline
    drifted to the all-time max and replicas stopped firing);
  * a FAILED replica with retries remaining is dropped, never requeued as
    an ordinary task;
  * replica records keep the translator's sticky/affinity/kind stamps.

The hard invariant throughout: checkpointed steps execute exactly once
across preempt / migrate / restart (replicas may legitimately overlap the
leader's in-flight step — first finisher wins)."""
import itertools
import json
import threading
import time

import pytest
import torch

from repro_torch.core import (Checkpoint, CheckpointStore, DataFlowKernel,
                              Pilot, PilotPool, ResourceSpec, RPEXExecutor,
                              SlotScheduler, SPMDFunctionExecutor, StateStore,
                              TaskPreempted, TaskState, python_app, spmd_app,
                              translate)
from repro_torch.core import PilotDescription as _PilotDescription
from repro_torch.core.agent import Agent


def PilotDescription(*args, **kw):
    """The suite's pilot descriptions on the CPU, asked for explicitly: a
    description without devices means every CUDA device, and raises
    without a card."""
    kw.setdefault("devices", [torch.device("cpu")])
    return _PilotDescription(*args, **kw)


# --------------------------- CheckpointStore ----------------------------- #

def test_checkpoint_store_save_latest_discard():
    store = StateStore()                     # journal-less: memory payloads
    ck = CheckpointStore(store)
    assert ck.latest("k") is None and not ck.has("k")
    assert ck.save("k", 0, {"s": 0})
    assert ck.save("k", 3, {"s": 3})
    assert ck.latest("k") == (3, {"s": 3})
    assert ck.step("k") == 3
    # steps are monotonic: a lagging writer cannot roll the key back
    assert not ck.save("k", 1, {"s": 1})
    assert ck.latest("k") == (3, {"s": 3})
    ck.discard("k")
    assert ck.latest("k") is None and ck.step("k") is None
    # save/gc markers land in the unified event stream
    evs = [e for e in store.events_snapshot()
           if e.get("event") == "CHECKPOINT"]
    assert [e.get("gc", False) for e in evs] == [False, False, True]


def test_checkpoint_store_journal_replay(tmp_path):
    """A restarted store replays its checkpoint map from CHECKPOINT
    events and lazy-loads the payload from the on-disk snapshot."""
    j = str(tmp_path / "j.jsonl")
    s = StateStore(j)
    ck = CheckpointStore(s)
    ck.save("wf/task:0", 0, {"w": [0]})
    ck.save("wf/task:0", 4, {"w": [0, 4]})
    ck.save("gone", 2, "x")
    ck.discard("gone")
    assert s.flush(timeout=10)
    s.close()

    s2 = StateStore(j)
    ck2 = CheckpointStore(s2)
    assert ck2.step("wf/task:0") == 4
    assert ck2.latest("wf/task:0") == (4, {"w": [0, 4]})
    assert ck2.latest("gone") is None     # gc marker replayed
    s2.close()

    # payload GC: one live payload file per key (older steps unlinked,
    # discarded keys gone entirely)
    pkls = list((tmp_path / "j.jsonl.ckpt").glob("*.pkl"))
    assert len(pkls) == 1 and ".4." in pkls[0].name


def test_checkpoint_events_collapse_under_compaction(tmp_path):
    """A long task journals one CHECKPOINT per saved step; compaction
    keeps only the latest per live key and drops gc'd keys, so the
    compacted journal stays O(live keys), and a restart still resumes
    from the right step."""
    j = tmp_path / "j.jsonl"
    s = StateStore(str(j), compact_min_lines=64, compact_factor=2)
    ck = CheckpointStore(s)
    for step in range(300):
        ck.save("live", step, {"s": step})
        ck.save("done", step, step)
    ck.discard("done")
    s.flush(timeout=10)
    s.close()

    lines = [json.loads(l) for l in j.read_text().splitlines()]
    assert any(r.get("event") == "_SNAPSHOT" for r in lines)
    ckpt_lines = [r for r in lines if r.get("event") == "CHECKPOINT"]
    keys = [r.get("key") for r in ckpt_lines if not r.get("gc")]
    # 600 saves happened; each compaction collapses history to one line
    # per live key, so only the post-last-compaction tail remains
    assert len(lines) < 200, f"journal never compacted: {len(lines)}"
    assert keys.count("live") < 64, "CHECKPOINT events were not collapsed"

    s2 = StateStore(str(j))
    ck2 = CheckpointStore(s2)
    assert ck2.step("live") == 299
    assert ck2.latest("live") == (299, {"s": 299})
    assert not ck2.has("done")
    s2.close()


def test_unpicklable_save_keeps_previous_durable_payload(tmp_path):
    """A newer save whose state cannot be pickled must not delete the
    previous step's payload: the journal still points at it, and a
    post-crash replay resumes from there (in-process, the newer step is
    served from memory)."""
    j = str(tmp_path / "j.jsonl")
    s = StateStore(j)
    ck = CheckpointStore(s)
    ck.save("k", 0, {"fine": 0})
    ck.save("k", 1, {"bad": threading.Lock()})     # unpicklable
    assert ck.latest("k")[0] == 1                  # in-process: memory
    pkls = list((tmp_path / "j.jsonl.ckpt").glob("*.pkl"))
    assert len(pkls) == 1 and ".0." in pkls[0].name, \
        "the durable step-0 payload was GC'd by the failed step-1 save"
    # a later successful save still GCs the old file
    ck.save("k", 2, {"fine": 2})
    pkls = list((tmp_path / "j.jsonl.ckpt").glob("*.pkl"))
    assert len(pkls) == 1 and ".2." in pkls[0].name
    assert s.flush(timeout=10)
    s.close()
    s2 = StateStore(j)
    ck2 = CheckpointStore(s2)
    # replay agrees with what restore() can deliver: step 1 was never
    # journaled (no durable payload), steps 0 and 2 were
    assert ck2.latest("k") == (2, {"fine": 2})
    s2.close()


def test_spawn_replica_rolls_back_when_agent_refuses():
    """A deadline firing while the agent is draining must not leave
    stale _replicas bookkeeping: the refused replica's entries roll
    back, so the leader stays eligible for the drain's preempt sweep."""
    pilot = Pilot(PilotDescription(n_slots=2, straggler_factor=1e9))
    try:
        lock, log = threading.Lock(), []
        t = translate(_resumable, (6, 0.05, log, lock), {},
                      ResourceSpec(checkpointable=True))
        pilot.agent.submit(t)
        time.sleep(0.12)                   # running, ctx live
        pilot.agent.stop_accepting()
        rep = pilot.agent._spawn_replica(t)
        assert rep.uid not in pilot.agent._replicas
        assert t.uid not in pilot.agent._replicated
        assert [x.uid for x in pilot.agent.preemptable_tasks()] == [t.uid]
        assert pilot.agent.wait_idle(timeout=10)
    finally:
        pilot.close()


def test_checkpoint_adopt_copies_newest():
    a, b = CheckpointStore(StateStore()), CheckpointStore(StateStore())
    a.save("k", 5, "five")
    assert b.adopt("k", a)
    assert b.latest("k") == (5, "five")
    # never rolls back: an older source is refused
    b.save("k", 7, "seven")
    assert not b.adopt("k", a)
    assert b.latest("k") == (7, "seven")
    assert not b.adopt("missing", a)


def test_checkpoint_context_preempt_boundary():
    ck = CheckpointStore(StateStore())
    ctx = Checkpoint(ck, "k")
    ctx.save(0, "a")                         # no preempt pending: returns
    assert not ctx.preempt_requested()
    ctx.request_preempt()
    with pytest.raises(TaskPreempted) as ei:
        ctx.save(1, "b")
    # the step was persisted BEFORE the unwind: nothing is lost
    assert ck.latest("k") == (1, "b")
    assert ei.value.step == 1 and ei.value.key == "k"
    assert ctx.restore() == (1, "b")


# ------------------------- straggler bugfixes ---------------------------- #

def _bare_agent(**kw):
    return Agent(SlotScheduler(2), SPMDFunctionExecutor([torch.device("cpu")]),
                 **kw)


def test_deadline_uses_recent_durations_not_largest():
    """Regression: the p95 must be over the ~100 most recent samples.
    Sorting the whole 256-deep deque first and slicing [-100:] took the
    100 *largest*, so one early slow phase inflated the deadline forever
    and replicas stopped firing."""
    ag = _bare_agent(straggler_factor=3.0)
    for _ in range(150):
        ag._durations.append(10.0)           # old, slow phase
    for _ in range(100):
        ag._durations.append(0.05)           # recent, fast phase
    dl = ag._deadline()
    assert dl is not None
    assert dl < 1.0, f"deadline {dl:.1f}s still reflects the oldest samples"
    assert dl == pytest.approx(0.15, rel=0.01)

    # the floor: micro-task p95s no longer produce deadlines shorter
    # than the monitor could even observe
    fast = _bare_agent(straggler_factor=3.0)
    for _ in range(100):
        fast._durations.append(0.001)
    assert fast._deadline() == pytest.approx(fast.straggler_min_deadline)


def test_replica_record_keeps_translator_stamps():
    """The monitor's replica TaskRecord must carry the original's
    sticky/affinity/kind stamps (journal + placement records match) and
    share its checkpoint key (that is what makes replicas resume)."""
    pilot = Pilot(PilotDescription(n_slots=2, straggler_factor=1e9))
    try:
        t = translate(lambda: "x", (), {},
                      ResourceSpec(sticky=True, affinity=("px", "py"),
                                   checkpointable=True, res_kind="cpu"))
        t.pilot_uid = pilot.uid
        rep = pilot.agent._spawn_replica(t)
        assert rep.replica_of == t.uid
        assert rep.sticky and rep.affinity == ("px", "py")
        assert rep.res_kind == "cpu" and rep.app_kind == t.app_kind
        assert rep.pilot_uid == pilot.uid
        assert rep.checkpointable and rep.ckpt_key == t.uid
        assert pilot.agent.wait_idle(timeout=10)
    finally:
        pilot.close()


def _straggler_body(counter, lock, log, n, leader_step_s, step_s,
                    leader_slow_after=0, fail_leader_at=None,
                    replica_raises=False, ckpt=None):
    """First invocation is the leader; it straggles (``leader_step_s``
    per step) from ``leader_slow_after`` on.  Later invocations are
    replicas running at the healthy ``step_s``."""
    with lock:
        me = next(counter)
    start = 0
    if ckpt is not None:
        got = ckpt.restore()
        if got is not None:
            start = got[0] + 1
    if me > 0 and replica_raises:
        raise RuntimeError("replica blew up")
    for step in range(start, n):
        slow = me == 0 and step >= leader_slow_after
        time.sleep(leader_step_s if slow else step_s)
        with lock:
            log.append((me, step))
        if ckpt is not None:
            ckpt.save(step, step)
        if me == 0 and fail_leader_at is not None and step == fail_leader_at:
            raise RuntimeError("leader failed")
    return {"who": me, "start": start}


def _seeded_pilot(**desc_kw):
    """Pilot whose agent has duration samples, so the straggler deadline
    is live (~3 x 30ms)."""
    pilot = Pilot(PilotDescription(n_slots=2, straggler_factor=3.0,
                                   **desc_kw))
    seeds = [translate(lambda: time.sleep(0.03), (), {}) for _ in range(5)]
    for s in seeds:
        pilot.agent.submit(s)
    assert pilot.agent.wait_idle(timeout=10)
    return pilot


def _run_straggler(pilot, timeout=20.0, **body_kw):
    lock = threading.Lock()
    log = []
    body_kw.setdefault("n", 6)
    t = translate(
        _straggler_body,
        (itertools.count(), lock, log, body_kw.pop("n"),
         body_kw.pop("leader_step_s"), body_kw.pop("step_s")), body_kw,
        ResourceSpec(checkpointable=True))
    t.max_retries = body_kw.get("max_retries", 0)
    res = []
    pilot.agent.submit(t, done_cb=res.append)
    deadline = time.monotonic() + timeout
    while not res and time.monotonic() < deadline:
        time.sleep(0.02)
    assert res, "straggler task never completed"
    assert pilot.agent.wait_idle(timeout=10)
    return t, res[0], log


@pytest.mark.timeout(60)
def test_replica_resumes_from_leader_checkpoint():
    """The replica restores the leader's latest saved step and wins from
    there — partial restart, not recompute-from-scratch."""
    pilot = _seeded_pilot()
    try:
        # leader saves steps 0-2 quickly, then grinds at 0.5s/step: the
        # replica fires past the ~100ms deadline and restores step >= 2
        t, done, log = _run_straggler(pilot, n=6, leader_step_s=0.5,
                                      step_s=0.02, leader_slow_after=3)
        assert done.state == TaskState.DONE
        assert done.result["who"] == 1, "replica did not win"
        assert done.result["start"] > 0, "replica recomputed from step 0"
        assert t.state == TaskState.CANCELED
        # every step completed by the winner exactly once; the leader may
        # only have contributed steps below the replica's start
        replica_steps = sorted(s for who, s in log if who == 1)
        assert replica_steps == list(range(done.result["start"], 6))
        # checkpoint GC'd once the task completed
        assert not pilot.agent.ckpt.has(t.ckpt_key)
    finally:
        pilot.close()


@pytest.mark.timeout(60)
def test_failed_replica_is_dropped_not_retried():
    """A replica that FAILs with retries remaining must be dropped: the
    original (still running) resolves the future, nothing requeues the
    replica as an ordinary task, and no third invocation ever happens."""
    pilot = _seeded_pilot()
    try:
        counter = itertools.count()
        lock, log = threading.Lock(), []
        t = translate(_straggler_body,
                      (counter, lock, log, 4, 0.1, 0.02),
                      {"replica_raises": True},
                      ResourceSpec(checkpointable=True))
        t.max_retries = 3                     # bait for the old retry path
        res = []
        pilot.agent.submit(t, done_cb=res.append)
        deadline = time.monotonic() + 20
        while not res and time.monotonic() < deadline:
            time.sleep(0.02)
        assert res and res[0].state == TaskState.DONE
        assert res[0].result["who"] == 0, "the leader must win"
        assert pilot.agent.wait_idle(timeout=10)
        time.sleep(0.2)                       # a requeued ghost would rerun
        invocations = next(counter)
        assert invocations >= 2, "replica never fired (deadline broken?)"
        # exactly one replica: dropped on failure (not retried as an
        # ordinary task) and not respawned in a storm while the leader
        # keeps running
        assert invocations == 2, "a failed replica was retried or respawned"
        assert t.retries == 0, "the original was charged the replica's retry"
        # the replica's FAILED is terminal in the store — never TRANSLATED
        # again afterwards
        reps = [uid for uid in pilot.store.states() if "replica" in uid]
        assert all(pilot.store.states()[u] == "FAILED" for u in reps)
    finally:
        pilot.close()


@pytest.mark.timeout(60)
def test_retryable_failure_on_original_still_retries():
    """The replica fix must not break ordinary retries: a non-replica
    FAILED task with retries remaining requeues (and, being
    checkpointable, resumes from its last saved step)."""
    pilot = Pilot(PilotDescription(n_slots=2, straggler_factor=1e9))
    try:
        counter = itertools.count()
        lock, log = threading.Lock(), []
        t = translate(_straggler_body,
                      (counter, lock, log, 5, 0.01, 0.01),
                      {"fail_leader_at": 2}, ResourceSpec(checkpointable=True))
        t.max_retries = 1
        res = []
        pilot.agent.submit(t, done_cb=res.append)
        assert pilot.agent.wait_idle(timeout=15)
        assert res and res[0].state == TaskState.DONE
        assert t.retries == 1
        # attempt 2 resumed after the failed step's checkpoint: each step
        # ran exactly once across both attempts
        assert sorted(s for _, s in log) == list(range(5))
    finally:
        pilot.close()


@pytest.mark.timeout(60)
def test_replica_succeeds_while_original_finishing():
    """Race the first-finisher-wins window: leader and replica complete
    nearly together; exactly one callback fires, the loser is CANCELED,
    and the agent settles."""
    pilot = _seeded_pilot()
    try:
        for _ in range(3):
            t, done, _ = _run_straggler(pilot, n=4, leader_step_s=0.06,
                                        step_s=0.05)
            assert done.state == TaskState.DONE
            states = {t.state, done.state}
            assert TaskState.DONE in states
            assert pilot.agent.wait_idle(timeout=10)
    finally:
        pilot.close()


# ------------------------- preempt-and-migrate --------------------------- #

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


@pytest.mark.timeout(60)
def test_preempt_and_migrate_running_task():
    """The tentpole: a RUNNING checkpointable task behind which
    un-stealable (sticky) work is queued migrates to the idle pilot at
    its next checkpoint boundary — STOLEN(reason=preempt), resumed at its
    saved step, every step executed exactly once."""
    pool = PilotPool([PilotDescription(n_slots=2, name="gen",
                                       straggler_factor=1e9),
                      PilotDescription(n_slots=2, kinds=("spmd", "device"),
                                       name="dev", straggler_factor=1e9)])
    try:
        gen, dev = pool.pilots
        lock, log = threading.Lock(), []
        lt = translate(_resumable, (10, 0.05, log, lock), {},
                       ResourceSpec(slots=2, checkpointable=True,
                                    res_kind="device"))
        lt.pilot_uid = gen.uid
        res = []
        gen.agent.submit(lt, done_cb=res.append)
        time.sleep(0.12)                    # running, >=1 step saved
        sres = []
        for _ in range(4):                  # sticky backlog: unstealable
            s = translate(lambda: time.sleep(0.03) or "s", (), {},
                          ResourceSpec(sticky=True))
            s.pilot_uid = gen.uid
            gen.agent.submit(s, done_cb=sres.append)

        assert pool.request_work(dev) > 0   # preempt requested
        deadline = time.monotonic() + 15
        while (not res or len(sres) < 4) and time.monotonic() < deadline:
            time.sleep(0.02)
        assert res and res[0].state == TaskState.DONE
        assert len(sres) == 4

        stolen = [e for e in pool.events() if e["event"] == "STOLEN"]
        assert [e["reason"] for e in stolen] == ["preempt"]
        assert stolen[0]["src"] == gen.uid and stolen[0]["dst"] == dev.uid
        assert lt.pilot_uid == dev.uid, "binding not re-stamped"
        assert res[0].result["start"] > 0, "did not resume from checkpoint"
        assert sorted(log) == list(range(10)) and len(log) == 10, \
            "a checkpointed step re-executed after the migration"
        # the checkpoint moved with the task and was GC'd on completion:
        # no pilot holds a stale copy a restart could wrongly resume from
        assert pool.checkpoint_step(lt.ckpt_key) is None
        assert not gen.ckpt.has(lt.ckpt_key), \
            "the migration left a stale checkpoint on the victim"
    finally:
        pool.close()


def test_preempt_declines_without_victim_backlog():
    """No queued demand on the victim -> preemption is pure thrash (two
    idle pilots would ping-pong the task) and must not fire."""
    pool = PilotPool([PilotDescription(n_slots=2, name="a",
                                       straggler_factor=1e9),
                      PilotDescription(n_slots=2, name="b",
                                       straggler_factor=1e9)])
    try:
        a, b = pool.pilots
        lock, log = threading.Lock(), []
        t = translate(_resumable, (6, 0.04, log, lock), {},
                      ResourceSpec(checkpointable=True))
        t.pilot_uid = a.uid
        res = []
        a.agent.submit(t, done_cb=res.append)
        time.sleep(0.1)
        assert pool.request_work(b) == 0
        deadline = time.monotonic() + 10
        while not res and time.monotonic() < deadline:
            time.sleep(0.02)
        assert res and res[0].state == TaskState.DONE
        assert t.pilot_uid == a.uid
        assert not any(e["event"] == "STOLEN" for e in pool.events())
    finally:
        pool.close()


def test_overtaken_preempt_notifies_handoff_with_none():
    """A preempt request whose task reaches a normal finish before its
    next save is dropped — and the handoff is invoked once with
    (None, None) so the requester (the pool's in-flight preempt budget)
    can release its reservation instead of leaking it forever."""
    pilot = Pilot(PilotDescription(n_slots=2, straggler_factor=1e9))
    try:
        gate = threading.Event()

        def body(ckpt=None):
            ckpt.save(0, "only")
            gate.wait(10)          # no further saves: preempt never lands
            return "done"

        t = translate(body, (), {}, ResourceSpec(checkpointable=True))
        res = []
        pilot.agent.submit(t, done_cb=res.append)
        time.sleep(0.1)            # running, step 0 saved
        drops = []
        assert pilot.agent.preempt(t.uid, lambda *a: drops.append(a))
        gate.set()
        assert pilot.agent.wait_idle(timeout=10)
        assert res and res[0].state == TaskState.DONE
        assert res[0].result == "done"
        assert drops == [(None, None)], \
            "dropped preempt request did not notify its requester"
    finally:
        gate.set()
        pilot.close()


def test_sticky_running_task_is_never_preempted():
    """sticky is the hard pin for RUNNING tasks too: the steal-path
    enumeration excludes it, so the pool finds no candidate — only the
    drain path (``include_sticky``) may move it, because a dying pilot
    cannot honor stickiness."""
    pilot = Pilot(PilotDescription(n_slots=2, straggler_factor=1e9))
    try:
        lock, log = threading.Lock(), []
        t = translate(_resumable, (5, 0.04, log, lock), {},
                      ResourceSpec(checkpointable=True, sticky=True))
        pilot.agent.submit(t)
        time.sleep(0.1)
        assert pilot.agent.preemptable_tasks() == []
        sticky_too = pilot.agent.preemptable_tasks(include_sticky=True)
        assert [x.uid for x in sticky_too] == [t.uid]
        assert pilot.agent.wait_idle(timeout=10)
        assert t.state == TaskState.DONE
    finally:
        pilot.close()


@pytest.mark.timeout(60)
def test_drain_hands_back_running_checkpointable_task():
    """A retiring pilot preempts its RUNNING checkpointable work at the
    next checkpoint boundary; the orphan resumes from the saved step on
    the survivor instead of blocking the retirement until completion."""
    pool = PilotPool([PilotDescription(n_slots=2, name="dying",
                                       straggler_factor=1e9),
                      PilotDescription(n_slots=2, name="survivor",
                                       straggler_factor=1e9)])
    try:
        dying, survivor = pool.pilots
        lock, log = threading.Lock(), []
        t = translate(_resumable, (10, 0.05, log, lock), {},
                      ResourceSpec(checkpointable=True))
        t.pilot_uid = dying.uid
        res = []
        dying.agent.submit(t, done_cb=res.append)
        time.sleep(0.12)                     # running with progress saved

        assert pool.retire(dying, timeout=15)
        assert survivor.agent.wait_idle(timeout=15)
        deadline = time.monotonic() + 10
        while not res and time.monotonic() < deadline:
            time.sleep(0.02)
        assert res and res[0].state == TaskState.DONE
        assert t.pilot_uid == survivor.uid
        assert res[0].result["start"] > 0, "restarted from scratch"
        assert sorted(log) == list(range(10)) and len(log) == 10
        events = pool.events()
        assert any(e["event"] == "PILOT_RETIRE" and e["pilot"] == dying.uid
                   for e in events)
    finally:
        pool.close()


# ------------------------------ restart ---------------------------------- #

@pytest.mark.timeout(60)
def test_restart_resumes_interrupted_task_from_checkpoint(tmp_path):
    """An interrupted keyed task replays from its last checkpoint on
    restart: the journal-backed CheckpointStore survives the process
    boundary (fresh StateStore + payload from disk), the DFK reports the
    resumed key, and no step runs twice across the two runs."""
    j = str(tmp_path / "p.jsonl")
    log = []
    fail = {"on": True}

    @python_app(checkpointable=True)
    def work(n, ckpt=None):
        start = 0
        got = ckpt.restore()
        if got is not None:
            start = got[0] + 1
        for step in range(start, n):
            log.append(step)
            ckpt.save(step, {"step": step})
            if fail["on"] and step == 3:
                raise RuntimeError("interrupted")
        return start

    r1 = RPEXExecutor(PilotDescription(n_slots=2, journal=j))
    with DataFlowKernel(executors={"rpex": r1}, run_id="ck") as dfk1:
        with pytest.raises(RuntimeError, match="interrupted"):
            work(8).result(timeout=15)
        assert dfk1.resumed_from_checkpoint == {}
    r1.shutdown()
    assert log == [0, 1, 2, 3]

    fail["on"] = False
    r2 = RPEXExecutor(PilotDescription(n_slots=2, journal=j))
    assert r2.checkpoint_step("ck/work:0") == 3
    with DataFlowKernel(executors={"rpex": r2}, run_id="ck") as dfk2:
        f = work(8)
        assert f.result(timeout=15) == 4          # resumed at step 4
        assert dfk2.resumed_from_checkpoint == {"ck/work:0": 3}
    r2.shutdown()
    assert log == list(range(8)), "steps re-executed across the restart"
    # completed: the third run replays DONE from the journal, no resume
    r3 = RPEXExecutor(PilotDescription(n_slots=2, journal=j))
    with DataFlowKernel(executors={"rpex": r3}, run_id="ck") as dfk3:
        assert work(8).result(timeout=15) == 4
        assert dfk3.resumed_from_checkpoint == {}
    r3.shutdown()
    assert log == list(range(8))


@pytest.mark.timeout(60)
def test_spmd_checkpointable_body_gets_mesh_and_ckpt():
    """@spmd_app(checkpointable=True): the body receives the sub-mesh
    first (the communicator analog) plus the ckpt context, un-jitted at
    the wrapper level."""
    rpex = RPEXExecutor(PilotDescription(n_slots=2, straggler_factor=1e9))
    try:
        seen = {}

        @spmd_app(slots=2, checkpointable=True)
        def seg(mesh, n, ckpt=None):
            seen["mesh_devices"] = mesh.size
            start = 0
            got = ckpt.restore()
            if got is not None:
                start = got[0] + 1
            for step in range(start, n):
                ckpt.save(step, step)
            return n - start

        with DataFlowKernel(executors={"rpex": rpex}):
            assert seg(3).result(timeout=15) == 3
        assert seen["mesh_devices"] >= 1
    finally:
        rpex.shutdown()
