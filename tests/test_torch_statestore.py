"""StateStore write-behind journal: group commit, drain-on-close,
torn-tail tolerance, the O(1) completed_result index, incremental
utilization/overhead counters, journal compaction, and event-stream
rebuild on restart (the PR-2 _replay bug: only `tasks` survived, so
post-restart utilization()/rp_overhead() silently undercounted)."""
import json
import threading
import time

import pytest
import torch

from repro_torch.core import (DataFlowKernel, RPEXExecutor,
                              StateStore, TaskRecord, TaskState, python_app,
                              overhead_from_events)
from repro_torch.core import PilotDescription as _PilotDescription


def PilotDescription(*args, **kw):
    """The suite's pilot descriptions on the CPU, asked for explicitly: a
    description without devices means every CUDA device, and raises
    without a card."""
    kw.setdefault("devices", [torch.device("cpu")])
    return _PilotDescription(*args, **kw)

pytestmark = pytest.mark.timeout(120)     # journal-heavy: fail fast, not wedge


def drive(store, uid, key=None, result=None, slots=(), fail_first=False):
    """Record a full task lifecycle through the store."""
    t = TaskRecord(uid=uid, kind="python")
    t.slot_ids = tuple(slots)
    for st in (TaskState.TRANSLATED, TaskState.SCHEDULED,
               TaskState.LAUNCHING, TaskState.RUNNING):
        t.state = st
        store.record(t, workflow_key=key)
    if fail_first:
        t.state = TaskState.FAILED
        store.record(t, workflow_key=key)
        for st in (TaskState.SCHEDULED, TaskState.LAUNCHING,
                   TaskState.RUNNING):
            t.state = st
            store.record(t, workflow_key=key)
    t.result = result
    t.state = TaskState.DONE
    store.record(t, workflow_key=key)
    return t


# --------------------------- write-behind ------------------------------- #

def test_group_commit_drains_on_close(tmp_path):
    """Records buffered in the write-behind queue all land on disk by the
    time close() returns — a clean shutdown loses nothing."""
    j = tmp_path / "j.jsonl"
    s = StateStore(str(j))
    for i in range(500):
        drive(s, f"t{i}", key=f"k{i}", result=i)
    s.close()
    s2 = StateStore(str(j))
    assert len(s2.tasks) == 500
    for i in (0, 123, 499):
        found, result = s2.completed_result(f"k{i}")
        assert found and result == i
    s2.close()


def test_flush_makes_records_durable_without_close(tmp_path):
    j = tmp_path / "j.jsonl"
    s = StateStore(str(j))
    drive(s, "t0", key="k0", result="r0")
    assert s.flush(timeout=10)
    lines = [json.loads(l) for l in j.read_text().splitlines()]
    assert any(r.get("uid") == "t0" and r.get("state") == "DONE"
               for r in lines)
    s.close()


def test_torn_tail_tolerated(tmp_path):
    """A partial (crash-torn) final line is skipped on replay; everything
    before it survives."""
    j = tmp_path / "j.jsonl"
    s = StateStore(str(j))
    drive(s, "a", key="ka", result=1)
    drive(s, "b", key="kb", result=2)
    s.close()
    with open(j, "a") as fh:
        fh.write('{"uid": "c", "state": "DO')     # torn mid-record
    s2 = StateStore(str(j))
    assert set(s2.tasks) == {"a", "b"}
    assert s2.completed_result("ka") == (True, 1)
    assert s2.completed_result("kb") == (True, 2)
    s2.close()


def test_record_after_close_is_memory_only(tmp_path):
    j = tmp_path / "j.jsonl"
    s = StateStore(str(j))
    drive(s, "a", key="ka", result=1)
    s.close()
    drive(s, "late", key="klate", result=9)       # must not raise
    assert s.completed_result("klate") == (True, 9)   # in memory
    s2 = StateStore(str(j))
    assert "late" not in s2.tasks                 # never journaled
    s2.close()
    s.close()                                     # idempotent


def test_concurrent_recorders_lose_nothing(tmp_path):
    j = tmp_path / "j.jsonl"
    s = StateStore(str(j))

    def work(base):
        for i in range(100):
            drive(s, f"t{base}-{i}", key=f"k{base}-{i}", result=i)

    threads = [threading.Thread(target=work, args=(b,)) for b in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    s.close()
    s2 = StateStore(str(j))
    assert len(s2.tasks) == 400
    for b in range(4):
        assert s2.completed_result(f"k{b}-99") == (True, 99)
    s2.close()


def test_non_jsonable_result_dropped_from_disk_and_not_pinned(tmp_path):
    j = tmp_path / "j.jsonl"
    s = StateStore(str(j))
    blob = object()                               # not JSON-serializable
    drive(s, "t0", key="k0", result=blob)
    assert s.flush(timeout=10)
    # once the writer slims the journal line it also unpins the result
    # from the in-memory maps — big device arrays must not accumulate
    found, _ = s.completed_result("k0")
    assert not found
    assert s.tasks["t0"]["state"] == "DONE"
    s.close()
    s2 = StateStore(str(j))
    found, _ = s2.completed_result("k0")          # line was slimmed down
    assert not found
    assert s2.tasks["t0"]["state"] == "DONE"      # record itself survived
    s2.close()


def test_writer_io_error_kills_journal_not_store(tmp_path):
    """A disk error in the writer thread (e.g. ENOSPC) marks the journal
    dead instead of silently killing the writer and wedging producers in
    backpressure: record() keeps working memory-only and never blocks."""
    j = tmp_path / "j.jsonl"
    s = StateStore(str(j), max_queue=8)

    class _BrokenFile:
        def write(self, _):
            raise OSError(28, "No space left on device")

        def flush(self):
            pass

        def close(self):
            pass

    drive(s, "t-pre", key="kpre", result=0)
    assert s.flush(timeout=10)
    with s._lock:
        s._fh.close()
        s._fh = _BrokenFile()
    t0 = time.monotonic()
    for i in range(64):                      # >> max_queue: must not wedge
        drive(s, f"t{i}", key=f"k{i}", result=i)
    assert time.monotonic() - t0 < 10
    deadline = time.monotonic() + 5
    while s.journal_error is None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert s.journal_error and "No space left" in s.journal_error
    assert s.completed_result("k63") == (True, 63)   # memory still live
    # the dead journal discarded queued records: flush() must not claim
    # durability for them
    assert not s.flush(timeout=5)
    s.close()                                # still clean to close
    s2 = StateStore(str(j))                  # pre-failure records survive
    assert s2.completed_result("kpre") == (True, 0)
    s2.close()


# ------------------------- O(1) key index ------------------------------- #

class _NoScanDict(dict):
    def values(self):
        raise AssertionError("completed_result scanned the task table")

    def items(self):
        raise AssertionError("completed_result scanned the task table")


def test_completed_result_is_indexed_not_scanned():
    s = StateStore()
    for i in range(50):
        drive(s, f"t{i}", key=f"k{i}", result=i)
    s.tasks = _NoScanDict(s.tasks)                # poison any scan
    for i in (0, 25, 49):
        assert s.completed_result(f"k{i}") == (True, i)
    assert s.completed_result("nope") == (False, None)
    s.close()


def test_done_record_not_displaced_by_later_incomplete_resubmission():
    """A completed (DONE + result) record keeps answering for its key even
    if a different task is later recorded under the same key without
    finishing — matching the old scan's 'find any completed' semantics."""
    s = StateStore()
    drive(s, "t-done", key="wf/app:0", result=42)
    t2 = TaskRecord(uid="t-retry", kind="python")
    t2.state = TaskState.TRANSLATED
    s.record(t2, workflow_key="wf/app:0")
    assert s.completed_result("wf/app:0") == (True, 42)
    # a different task completing under the same key does not displace the
    # first completion either (the old scan returned the first-inserted
    # completed record; and the newcomer's result may later be stripped
    # as non-serializable, which must not lose the key)
    t2.result = 43
    t2.state = TaskState.DONE
    s.record(t2, workflow_key="wf/app:0")
    assert s.completed_result("wf/app:0") == (True, 42)
    # the same task progressing does update its own entry
    t1 = TaskRecord(uid="t-done", kind="python")
    t1.result = 44
    t1.state = TaskState.DONE
    s.record(t1, workflow_key="wf/app:0")
    assert s.completed_result("wf/app:0") == (True, 44)
    s.close()


# ---------------------- incremental counters ---------------------------- #

def _offline_utilization(events, capacity):
    """The PR-2 full-stream recomputation, kept here as the reference."""
    slots = {}
    evs = [e for e in events if e.get("event") == "STATE"]
    for e in evs:
        slots[e["uid"]] = max(slots.get(e["uid"], 1), e.get("slots", 1))
    tl = {}
    for e in evs:
        tl.setdefault(e["uid"], {}).setdefault(e["state"], e["t"])
    if not tl:
        return {"Scheduled": 0.0, "Launching": 0.0, "Running": 0.0,
                "Idle": 1.0}
    all_t = [t for ts in tl.values() for t in ts.values()]
    t0, t1 = min(all_t), max(all_t)
    occ = {"Scheduled": 0.0, "Launching": 0.0, "Running": 0.0}
    ends_states = ("DONE", "FAILED", "CANCELED")
    for uid, ts in tl.items():
        n = slots.get(uid, 1)
        if "SCHEDULED" in ts and "LAUNCHING" in ts:
            occ["Scheduled"] += n * (ts["LAUNCHING"] - ts["SCHEDULED"])
        if "LAUNCHING" in ts and "RUNNING" in ts:
            occ["Launching"] += n * (ts["RUNNING"] - ts["LAUNCHING"])
        ends = [ts[s] for s in ends_states if s in ts]
        if "RUNNING" in ts and ends:
            occ["Running"] += n * max(0.0, min(ends) - ts["RUNNING"])
    total = max(capacity * (t1 - t0), 1e-12)
    scale = min(1.0, total / max(sum(occ.values()), 1e-12))
    occ = {k: v * scale for k, v in occ.items()}
    out = {k: v / total for k, v in occ.items()}
    out["Idle"] = max(0.0, 1.0 - sum(out.values()))
    return out


def test_incremental_counters_match_offline_recompute():
    s = StateStore()
    for i in range(40):
        drive(s, f"t{i}", slots=(i % 3,) * (i % 3 or 1),
              fail_first=(i % 7 == 0))
    events = s.events_snapshot()
    want = _offline_utilization(events, capacity=8)
    got = s.utilization(8)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-9), k
    assert s.overhead() == pytest.approx(overhead_from_events(events),
                                         abs=1e-9)
    # timeline cache matches first-occurrence reconstruction
    tl = s.timeline()
    for e in events:
        if e.get("event") == "STATE":
            assert tl[e["uid"]][e["state"]] <= e["t"]
    s.close()


# ----------------------- restart event rebuild -------------------------- #

def test_replay_rebuilds_event_stream(tmp_path):
    """PR-2 dropped the event stream on restart (only `tasks` came back),
    so post-restart utilization()/rp_overhead() silently undercounted.
    Replay now reconstructs STATE events from the journal's monotonic
    stamps and replays journaled runtime events."""
    j = tmp_path / "j.jsonl"
    s = StateStore(str(j))
    s.record_event("PILOT_START", pilot="p0", n_slots=4)
    for i in range(10):
        drive(s, f"t{i}", key=f"k{i}", result=i)
    util_before = s.utilization(4)
    oh_before = s.overhead()
    n_events = len(s.events_snapshot())
    s.close()

    s2 = StateStore(str(j))
    events = s2.events_snapshot()
    assert len(events) == n_events
    kinds = {e["event"] for e in events}
    assert "PILOT_START" in kinds and "STATE" in kinds
    states = {e["state"] for e in events if e.get("event") == "STATE"}
    assert {"TRANSLATED", "SCHEDULED", "RUNNING", "DONE"} <= states
    for k in util_before:
        assert s2.utilization(4)[k] == pytest.approx(util_before[k],
                                                     rel=1e-6, abs=1e-9)
    assert s2.overhead() == pytest.approx(oh_before, rel=1e-6, abs=1e-9)
    assert s2.timeline()                      # not empty post-restart
    s2.close()


def test_rp_overhead_survives_executor_restart(tmp_path):
    """End-to-end: a restarted RPEXExecutor over the same journal reports
    nonzero rp_overhead from the pre-restart run."""
    journal = str(tmp_path / "wf.jsonl")

    @python_app
    def work(x):
        time.sleep(0.01)
        return x + 1

    r1 = RPEXExecutor(PilotDescription(n_slots=2, journal=journal))
    with DataFlowKernel(executors={"rpex": r1}, run_id="rr"):
        assert work(1).result() == 2
    oh1 = r1.rp_overhead()
    r1.shutdown()
    assert oh1 > 0

    r2 = RPEXExecutor(PilotDescription(n_slots=2, journal=journal))
    oh2 = r2.rp_overhead()                    # before running anything new
    assert oh2 == pytest.approx(oh1, rel=1e-6, abs=1e-9)
    util = r2.pilot.store.utilization(2)
    assert util["Idle"] < 1.0                 # history visible, not erased
    r2.shutdown()


# --------------------------- compaction --------------------------------- #

def test_compaction_snapshots_and_preserves_state(tmp_path):
    j = tmp_path / "j.jsonl"
    s = StateStore(str(j), compact_min_lines=64, compact_factor=2)
    # many transitions over few tasks: the journal grows far beyond the
    # live record count, so the writer compacts to snapshot + tail
    for round_ in range(30):
        for i in range(8):
            drive(s, f"t{i}", key=f"k{i}", result=round_)
        s.flush(timeout=10)
    util_before = s.utilization(8)
    oh_before = s.overhead()
    s.close()

    lines = [json.loads(l) for l in j.read_text().splitlines()]
    # 30 rounds x 8 tasks x 6 transitions = 1440 records without compaction
    assert len(lines) < 400, f"journal never compacted: {len(lines)} lines"
    assert any(r.get("event") == "_SNAPSHOT" for r in lines)

    s2 = StateStore(str(j), compact_min_lines=64, compact_factor=2)
    assert len(s2.tasks) == 8
    for i in range(8):
        assert s2.completed_result(f"k{i}") == (True, 29)
    # aggregate stats carried across the snapshot boundary: the busy
    # fraction is preserved within tolerance, not reset to idle
    util_after = s2.utilization(8)
    assert util_after["Idle"] < 1.0
    for k in ("Scheduled", "Launching", "Running"):
        assert util_after[k] == pytest.approx(util_before[k],
                                              rel=0.05, abs=1e-4)
    # overhead survives too: the snapshot's scalar base plus tail
    # intervals (overhead_base feeds rp_overhead after a restart)
    assert s2.overhead() == pytest.approx(oh_before, rel=0.05, abs=1e-4)
    assert s2.overhead_base() > 0
    s2.close()


def test_compaction_with_queued_records_does_not_double_count(tmp_path):
    """Records still in the write-behind queue when the writer compacts
    are already folded into the snapshot stats; they must not also land
    in the tail, or a restart ingests them twice and over-reports
    utilization/overhead."""
    j = tmp_path / "j.jsonl"
    s = StateStore(str(j), compact_min_lines=48, compact_factor=2)
    for round_ in range(40):                 # no flush(): queue stays hot
        for i in range(6):
            drive(s, f"t{i}", key=f"k{i}", result=round_)
    util_before = s.utilization(8)
    oh_before = s.overhead()
    s.close()
    s2 = StateStore(str(j), compact_min_lines=48, compact_factor=2)
    assert len(s2.tasks) == 6
    for i in range(6):
        assert s2.completed_result(f"k{i}") == (True, 39)
    for k in ("Scheduled", "Launching", "Running"):
        assert s2.utilization(8)[k] == pytest.approx(util_before[k],
                                                     rel=0.05, abs=1e-4)
    assert s2.overhead() == pytest.approx(oh_before, rel=0.05, abs=1e-4)
    s2.close()


def test_compaction_preserves_runtime_events(tmp_path):
    """Pilot-lifecycle events (PILOT_START/STOLEN/...) survive compaction
    even after they were flushed to the pre-compaction journal; per-task
    ROUTED events are the documented drop (each task record keeps its
    pilot binding)."""
    j = tmp_path / "j.jsonl"
    s = StateStore(str(j), compact_min_lines=48, compact_factor=2)
    s.record_event("PILOT_START", pilot="p0", n_slots=4)
    s.record_event("STOLEN", uid="tx", src="p0", dst="p1")
    s.record_event("ROUTED", uid="t0", pilot="p0")
    s.flush(timeout=10)                      # events hit the old journal
    for round_ in range(40):                 # force >=1 compaction
        for i in range(6):
            drive(s, f"t{i}", key=f"k{i}", result=round_)
        s.flush(timeout=10)
    s.close()
    s2 = StateStore(str(j), compact_min_lines=48, compact_factor=2)
    kinds = [e["event"] for e in s2.events_snapshot()]
    assert "PILOT_START" in kinds and "STOLEN" in kinds
    assert "ROUTED" not in kinds             # compaction drops these
    s2.close()


def test_compaction_tail_preserves_recent_timelines(tmp_path):
    """The bounded event tail: recent per-task state timelines survive a
    compaction + restart (stamp-exact within the same boot), older ones
    are the documented drop, and the tail never double-counts into the
    aggregate utilization/overhead counters (the snapshot stats already
    carry it)."""
    j = tmp_path / "j.jsonl"
    kw = dict(compact_min_lines=48, compact_factor=2,
              compact_tail_events=64)
    s = StateStore(str(j), **kw)
    # distinct uid per round: early rounds age out of the tail window,
    # late rounds stay inside it
    for round_ in range(30):
        for i in range(3):
            drive(s, f"r{round_}_t{i}", key=f"r{round_}_k{i}",
                  result=round_)
        s.flush(timeout=10)
    tl_before = s.timeline()
    util_before = s.utilization(8)
    oh_before = s.overhead()
    s.close()

    lines = [json.loads(l) for l in j.read_text().splitlines()]
    assert any(r.get("tail") for r in lines), "no event tail written"

    s2 = StateStore(str(j), **kw)
    tl_after = s2.timeline()
    # uids whose transitions exist ONLY as tail events (their task lines
    # are snapshot summaries): the timeline must come from the tail
    regular_uids = {r["uid"] for r in lines
                    if "uid" in r and "event" not in r
                    and not r.get("snap")}
    tail_only = {r["uid"] for r in lines
                 if r.get("tail")} - regular_uids
    assert tail_only, "no uid exercises the tail-only replay path"
    for uid in tail_only:
        got = tl_after.get(uid)
        assert got, f"tail-only uid lost its timeline: {uid}"
        for st, t in got.items():
            assert t == pytest.approx(tl_before[uid][st], abs=1e-9), uid
    # the last rounds' tasks keep their full per-state timeline, with the
    # exact stamps (same boot: no epoch shift)
    recent = [u for u in tl_before if u.startswith("r29_")]
    assert recent
    for uid in recent:
        assert tl_after.get(uid) == tl_before[uid], uid
    # a bounded tail cannot hold everything: the earliest rounds' full
    # timelines are gone (their latest state survives in the snapshot)
    assert "r0_t0" not in tl_after
    assert len(s2.tasks) == 90                 # ...but no record is lost
    assert s2.completed_result("r0_k0") == (True, 0)
    # and the aggregates match pre-restart: tail events were folded in as
    # timeline-only, never double-ingested into the counters
    for k in ("Scheduled", "Launching", "Running"):
        assert s2.utilization(8)[k] == pytest.approx(util_before[k],
                                                     rel=0.05, abs=1e-4)
    assert s2.overhead() == pytest.approx(oh_before, rel=0.05, abs=1e-4)
    s2.close()


def test_replay_translates_monotonic_epoch_across_reboot(tmp_path):
    """A journal written in a previous boot carries monotonic stamps from
    a different epoch; replay re-anchors them via the wall stamps so the
    rebuilt counters stay sane instead of spanning both epochs."""
    j = tmp_path / "j.jsonl"
    s = StateStore(str(j))
    s.record_event("PILOT_START", pilot="p0", n_slots=4)
    for i in range(10):
        drive(s, f"t{i}", key=f"k{i}", result=i)
    util_before = s.utilization(4)
    oh_before = s.overhead()
    s.close()

    # simulate the reboot: shift every monotonic stamp by a huge offset,
    # as if the previous boot's CLOCK_MONOTONIC epoch were far away
    shift = 7.2e6
    lines = []
    for line in j.read_text().splitlines():
        rec = json.loads(line)
        if "event" in rec:
            rec["t"] += shift                # wt stays wall-anchored
        else:
            rec["mt"] += shift               # t stays wall-anchored
        lines.append(json.dumps(rec))
    j.write_text("\n".join(lines) + "\n")

    s2 = StateStore(str(j))
    util_after = s2.utilization(4)
    # each line re-anchors via its own wall stamp, whose sampling jitter
    # vs the monotonic stamp is ~us — integrals match to ~percent
    for k in util_before:
        assert util_after[k] == pytest.approx(util_before[k],
                                              rel=0.05, abs=1e-4), k
    assert s2.overhead() == pytest.approx(oh_before, rel=0.05, abs=1e-4)
    # rebuilt stamps live in the current boot's monotonic domain
    tl = s2.timeline()
    now = __import__("time").monotonic()
    for ts in tl.values():
        for t in ts.values():
            assert abs(t - now) < 3600
    s2.close()


def test_compacted_journal_still_tolerates_torn_tail(tmp_path):
    j = tmp_path / "j.jsonl"
    s = StateStore(str(j), compact_min_lines=32, compact_factor=2)
    for round_ in range(20):
        for i in range(4):
            drive(s, f"t{i}", key=f"k{i}", result=round_)
        s.flush(timeout=10)
    s.close()
    with open(j, "a") as fh:
        fh.write('{"uid": "torn"')
    s2 = StateStore(str(j), compact_min_lines=32, compact_factor=2)
    assert len(s2.tasks) == 4
    assert s2.completed_result("k0") == (True, 19)
    s2.close()
