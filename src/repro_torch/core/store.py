"""StateStore — the MongoDB analog: journaled task/pilot state.

RP uses a MongoDB instance to share state between client-side managers and
the agent; in a single-controller JAX deployment the equivalent is an
in-process store with a JSON-lines journal on disk.  The journal gives the
workflow layer crash-consistent restart: a restarted DFK replays DONE tasks
(futures resolve immediately from recorded results when re-submitted with
the same workflow key) and resubmits in-flight ones.

Beyond the per-task latest-state map, the store keeps a *unified event
stream*: every task transition and every runtime event (pilot start, route
decision, elastic resize) is appended as one timestamped record.  The
stream replaces the ad-hoc per-component timestamp dicts the runtime used
to keep — per-pilot utilization (the paper's Fig. 6 Scheduled/Launching/
Running/Idle breakdown) is integrated directly from it.

Since PR 3 the store is an *off-critical-path* subsystem:

  * Journal writes are write-behind with group commit: ``record`` appends
    the merged record to a bounded in-memory queue and returns; a
    background writer thread drains the queue, serializes the whole batch,
    and lands it with one ``write`` + one ``flush`` per drain cycle.
    ``close()`` drains the queue before closing the file, so a clean
    shutdown loses nothing; a hard crash loses at most the queue window,
    and the replay path tolerates a torn tail line either way.
  * ``completed_result`` is O(1): a ``workflow_key -> record`` index is
    maintained on append (and on replay) instead of scanning every record.
  * ``utilization()`` / ``timeline()`` / ``overhead()`` read counters that
    are maintained incrementally as events append, so PoolScaler wakeups
    and benchmark probes never re-integrate the full event stream.
  * Long elastic runs compact the journal in place (snapshot + tail): when
    the file holds many times more lines than live task records, the
    writer thread atomically rewrites it as one snapshot line per task
    plus a stats header — and a *bounded event tail*: the most recent
    STATE events ride along (marked ``tail``, wall-stamped for epoch
    re-anchoring) so recent per-task state timelines survive compaction.
    ``CHECKPOINT`` events (the task-checkpoint subsystem's save/gc
    markers, see checkpoint.py) collapse to one line per live key.
    Replay ingests tail events into the timeline only — their aggregate
    contribution already lives in the stats header, so counters never
    double-count.
  * A per-(app_kind, pilot) duration model rides the same incremental
    path: EWMA mean/variance of observed DONE run times folded in
    ``_ingest``, snapshotted into the compaction stats header, rebuilt on
    replay, and seedable cross-pilot by kind — the signal every
    cost-model scheduling decision reads (see docs/scheduling.md).
  * Restart rebuilds the event stream: every journal line carries a
    monotonic timestamp (``mt``), so ``_replay`` reconstructs the STATE
    events (and replays journaled runtime events) instead of dropping
    them — post-restart ``utilization()``/``rp_overhead()`` see the
    pre-restart history instead of silently undercounting.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Deque, Dict, List, Optional, Tuple

from . import serializer
from .futures import TaskRecord, TaskState
from .objectstore import ObjectRef

_RUN_STATES = ("SCHEDULED", "LAUNCHING", "RUNNING")
_END_STATES = ("DONE", "FAILED", "CANCELED")


class EVENTS:
    """Central registry of journaled event names — the single source of
    truth the event-protocol checker (``repro_torch.analysis.events``) holds
    emitters, replay, compaction, and listeners against.

    Every name written into a journal ``{"event": ...}`` record must be
    declared here, and every emitter/consumer in ``src/repro_torch/core``
    must reference the registry constant rather than a string literal, so
    drift (emitted-but-never-replayed, consumed-but-never-emitted,
    undeclared) is mechanically checkable."""

    STATE = "STATE"                     # task state transition (record())
    SNAPSHOT = "_SNAPSHOT"              # compaction header line
    CHECKPOINT = "CHECKPOINT"           # task-checkpoint save/gc marker
    PILOT_START = "PILOT_START"         # pilot came up
    PILOT_RETIRE = "PILOT_RETIRE"       # pilot drained + retired
    PILOT_LOST = "PILOT_LOST"           # heartbeat/crash loss declared
    GROW = "GROW"                       # elastic resize: slots added
    SHRINK = "SHRINK"                   # elastic resize: slots removed
    ROUTED = "ROUTED"                   # pool routing decision
    STOLEN = "STOLEN"                   # work-stealing / re-route event
    QUARANTINED = "QUARANTINED"         # poison task terminally failed
    SHUTDOWN_STRANDED = "SHUTDOWN_STRANDED"   # hung tasks at shutdown
    OBJECTS_REHOSTED = "OBJECTS_REHOSTED"     # data-plane ownership move

    @classmethod
    def all_names(cls):
        return frozenset(v for k, v in vars(cls).items()
                         if isinstance(v, str) and not k.startswith("_"))

# Replay clock translation: journal stamps are time.monotonic(), whose
# epoch resets on reboot.  Each line also carries a wall stamp, so replay
# detects an epoch mismatch (boot offsets differing by more than this many
# seconds) and shifts old stamps into the current boot's monotonic domain.
_EPOCH_TOL_S = 600.0


class StateStore:
    def __init__(self, journal_path: Optional[str] = None,
                 max_queue: int = 8192,
                 compact_min_lines: int = 4096,
                 compact_factor: int = 4,
                 compact_tail_events: int = 256,
                 dur_alpha: float = 0.2):
        self.journal_path = Path(journal_path) if journal_path else None
        self.objectstore = None         # pool-wired data plane: DONE
                                        # records with ObjectRef results
                                        # journal ref metadata and spill
                                        # through it (docs/dataplane.md)
        self._lock = threading.Lock()
        self.tasks: Dict[str, dict] = {}
        self.events: List[dict] = []        # unified, append-only stream
        self._listeners: List[Any] = []     # fired (outside the lock) on
                                            # every appended event
        # key -> record index (O(1) completed_result); a DONE-with-result
        # record is never displaced by a later non-DONE record of another
        # uid, matching the old scan's "find any completed" semantics
        self._by_key: Dict[str, dict] = {}

        # ---- incremental counters (maintained on every STATE append) ----
        self._timeline: Dict[str, Dict[str, float]] = {}
        self._slots_max: Dict[str, int] = {}
        self._occ = {"Scheduled": 0.0, "Launching": 0.0, "Running": 0.0}
        self._ended: set = set()            # uids past their first terminal
        self._t_min: Optional[float] = None
        self._t_max: Optional[float] = None
        # streaming overhead union: wall-clock with >=1 task in
        # [SCHEDULED, RUNNING) — active-count sweep over the ordered stream
        self._oh_opens: Dict[str, float] = {}
        self._oh_active = 0
        self._oh_ustart = 0.0               # start of the current busy span
        self._oh_cur = 0.0                  # closed union inside that span
        self._oh_total = 0.0
        self._oh_seeded = 0.0               # pre-compaction overhead whose
                                            # intervals were snapshotted away
        self._oh_ivals: List[Tuple[float, float]] = []  # for cross-pilot union
        # ---- duration model (cost-model scheduling, see docs/scheduling.md)
        # kind -> [ewma_mean_s, ewma_var_s2, n_samples] of observed DONE run
        # times; folded in _ingest like the other counters, snapshotted into
        # the compaction stats header, and seedable cross-pilot by kind.
        self._dur: Dict[str, List[float]] = {}
        self._dur_open: Dict[str, float] = {}   # uid -> latest RUNNING t
        self._dur_alpha = dur_alpha

        # ---- write-behind journal ----
        self._fh = None
        self._wq: Deque[dict] = deque()
        self._wcv = threading.Condition()
        self._wstop = False
        self._wsleeping = False             # writer parked on its cv
        self._winflight = 0                 # records popped, not yet on disk
        self.journal_error: Optional[str] = None   # set when an I/O error
                                            # killed journaling (memory-only
                                            # operation continues)
        self._writer: Optional[threading.Thread] = None
        self._max_queue = max_queue
        self._compact_min_lines = compact_min_lines
        self._compact_factor = compact_factor
        self._compact_tail_events = compact_tail_events
        self._journal_lines = 0
        if self.journal_path:
            self.journal_path.parent.mkdir(parents=True, exist_ok=True)
            if self.journal_path.exists():
                self._replay()
            self._fh = open(self.journal_path, "a")
            self._writer = threading.Thread(target=self._writer_loop,
                                            daemon=True)
            self._writer.start()

    # ------------------------------ replay ------------------------------ #
    @staticmethod
    def _epoch_delta(wall: Optional[float], mono: float,
                     cur_off: float) -> float:
        """Shift (seconds) to translate a journaled monotonic stamp into
        the current boot's monotonic domain; 0.0 within the same boot."""
        if wall is None:
            return 0.0
        delta = (wall - mono) - cur_off
        return delta if abs(delta) > _EPOCH_TOL_S else 0.0

    def _replay(self):
        cur_off = time.time() - time.monotonic()
        with open(self.journal_path) as fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue        # torn tail write from a crash
                self._journal_lines += 1
                if rec.get("event") == EVENTS.SNAPSHOT:
                    stats = dict(rec.get("stats") or {})
                    snap_off = rec.get("mono_offset")
                    if snap_off is not None \
                            and abs(snap_off - cur_off) > _EPOCH_TOL_S:
                        for b in ("t_min", "t_max"):
                            if stats.get(b) is not None:
                                stats[b] += snap_off - cur_off
                    self._seed_stats(stats)
                    continue
                if "event" in rec:              # journaled runtime event
                    shift = self._epoch_delta(rec.get("wt"), rec["t"],
                                              cur_off)
                    if rec.pop("tail", None):
                        # bounded event tail from a compaction snapshot:
                        # restore the recent per-task state timeline, but
                        # timeline ONLY — these events' occ/overhead
                        # contribution is already in the stats header
                        ev = {k: v for k, v in rec.items() if k != "wt"}
                        ev["t"] += shift
                        self.events.append(ev)
                        self._ingest_timeline_only(ev)
                        continue
                    if shift:
                        rec = {**rec, "t": rec["t"] + shift}
                    self.events.append(rec)
                    continue
                if "uid" not in rec:
                    continue
                self.tasks[rec["uid"]] = rec
                self._index_key(rec)
                # rebuild the STATE stream: every journal line is one
                # transition, stamped with its monotonic time.  Snapshot
                # lines ("snap") are latest-state summaries whose history
                # was compacted away — their aggregate contribution is
                # carried by the _SNAPSHOT stats line instead.
                if "mt" in rec and not rec.get("snap"):
                    mt = rec["mt"] + self._epoch_delta(rec.get("t"),
                                                       rec["mt"], cur_off)
                    ev = {"event": EVENTS.STATE, "uid": rec["uid"],
                          "state": rec["state"], "t": mt,
                          "slots": len(rec.get("slot_ids") or ()) or 1,
                          "pilot": rec.get("pilot"),
                          "kind": rec.get("akind") or rec.get("kind")}
                    self.events.append(ev)
                    self._ingest(ev)

    def _seed_stats(self, stats: dict):
        """Restore aggregate counters from a compaction snapshot header."""
        for k, v in (stats.get("occ") or {}).items():
            if k in self._occ:
                self._occ[k] += float(v)
        self._oh_seeded += float(stats.get("oh_total", 0.0))
        for kind, (mean, var, n) in (stats.get("dur") or {}).items():
            self._dur_merge(kind, mean, var, n)
        for bound, pick in (("t_min", min), ("t_max", max)):
            v = stats.get(bound)
            if v is not None:
                cur = getattr(self, f"_{bound}")
                setattr(self, f"_{bound}",
                        float(v) if cur is None else pick(cur, float(v)))

    # ------------------------------ events ------------------------------ #
    def add_listener(self, cb):
        """Register a callback fired (outside the store lock) with each
        appended event record — the PoolScaler's wake-up source."""
        with self._lock:
            self._listeners.append(cb)

    def _notify(self, rec: dict):
        for cb in list(self._listeners):
            cb(rec)

    def record_event(self, event: str, **fields):
        """Append a non-task runtime event (pilot start, routing, resize,
        steal, retire).  Journaled (write-behind) so a restarted store
        sees the full runtime event history, not just task states; the
        wall stamp ("wt") lets replay re-anchor the monotonic stamp after
        a reboot."""
        rec = {"event": event, "t": time.monotonic(), "wt": time.time(),
               **fields}
        with self._lock:
            self.events.append(rec)
            if self._fh is not None:
                self._wq.append(rec)
        self._wake_writer()
        if self._listeners:
            self._notify(rec)

    def record(self, task: TaskRecord, workflow_key: Optional[str] = None):
        """Append one task transition.  The critical-path cost is a dict
        merge plus counter updates under the lock; serialization and disk
        I/O happen on the writer thread (group commit)."""
        rec = {
            "uid": task.uid,
            "key": workflow_key,
            "kind": task.kind,
            "state": task.state.value,
            "retries": task.retries,
            "slot_ids": list(task.slot_ids),
            "t": time.time(),
            "mt": time.monotonic(),
        }
        if task.pilot_uid is not None:
            rec["pilot"] = task.pilot_uid
        if task.app_kind and task.app_kind != task.kind:
            # the duration model keys on the *app* kind (bash apps execute
            # as kind "python" but their run times are a bash population)
            rec["akind"] = task.app_kind
        if task.state == TaskState.DONE:
            if isinstance(task.result, ObjectRef):
                # data plane: the line carries the ref *metadata* only;
                # the writer spills the payload (durable-before-event)
                # instead of re-serializing a large result through the
                # json probe — the old double-serialization path
                rec["result_ref"] = {"oid": task.result.oid,
                                     "size": task.result.size,
                                     "kind": task.result.kind}
            # journaled: jsonability is checked by the writer thread (the
            # dumps is the expensive part) which also unpins the result
            # from memory if it cannot be serialized.  Journal-less: no
            # writer will ever strip it, so gate synchronously (PR-2
            # behavior) rather than pin arbitrary result objects forever.
            elif self._fh is not None or _jsonable(task.result):
                rec["result"] = task.result
        if task.error is not None:
            rec["error"] = repr(task.error)[:500]
        if task.attempt_errors:
            # why each prior attempt failed (the retry path keeps the
            # history instead of wiping task.error): a FAILED record in
            # the journal shows all N attempts, matching the __cause__
            # chain the surfaced exception carries
            rec["attempt_errors"] = [repr(e)[:200]
                                     for e in task.attempt_errors]
        ev = {
            "event": EVENTS.STATE, "uid": task.uid,
            "state": task.state.value, "t": rec["mt"],
            "slots": len(task.slot_ids) or 1,
            "pilot": task.pilot_uid,
            "kind": task.app_kind or task.kind,
        }
        with self._lock:
            prev = self.tasks.get(task.uid)
            if prev:
                if rec.get("key") is None:
                    rec["key"] = prev.get("key")
                merged = {**prev, **rec}
            else:
                merged = rec
            self.tasks[task.uid] = merged
            self._index_key(merged)
            self.events.append(ev)
            self._ingest(ev)
            if self._fh is not None:
                self._wq.append(merged)
        self._wake_writer()
        if self._listeners:
            self._notify(ev)

    def _index_key(self, rec: dict):
        """Caller holds self._lock.  Latest record wins, except that a
        completed record (DONE with a result) is only displaced by another
        record of the *same* task — a later resubmission cannot hide an
        earlier completion, whether it never finished or finished with a
        result the writer later strips as non-serializable.  (The old
        linear scan returned the first completed record in insertion
        order, which is the same answer.)"""
        key = rec.get("key")
        if key is None:
            return
        cur = self._by_key.get(key)
        if (cur is not None and cur.get("uid") != rec.get("uid")
                and cur.get("state") == TaskState.DONE.value
                and ("result" in cur or "result_ref" in cur)):
            return
        self._by_key[key] = rec

    def _ingest_timeline_only(self, ev: dict):
        """Fold a compaction-tail STATE event into the per-task timeline
        (first occurrence wins) without touching the occ/overhead
        aggregates — those already carry it via the snapshot stats."""
        uid, state, t = ev["uid"], ev["state"], ev["t"]
        n = max(self._slots_max.get(uid, 1), ev.get("slots", 1))
        self._slots_max[uid] = n
        ts = self._timeline.setdefault(uid, {})
        if state not in ts:
            ts[state] = t

    # ----------------------- incremental counters ----------------------- #
    def _ingest(self, ev: dict):
        """Caller holds self._lock.  Fold one STATE event into the cached
        utilization / timeline / overhead counters.  Equivalent to the old
        full-stream recomputation because events arrive in time order and
        the old integration only ever used the *first* occurrence of each
        state per uid (and the earliest terminal stamp)."""
        uid, state, t = ev["uid"], ev["state"], ev["t"]
        self._t_min = t if self._t_min is None else min(self._t_min, t)
        self._t_max = t if self._t_max is None else max(self._t_max, t)
        n = max(self._slots_max.get(uid, 1), ev.get("slots", 1))
        self._slots_max[uid] = n
        ts = self._timeline.setdefault(uid, {})
        first = state not in ts
        if first:
            ts[state] = t
        if state == "LAUNCHING" and first and "SCHEDULED" in ts:
            self._occ["Scheduled"] += n * (t - ts["SCHEDULED"])
        elif state == "RUNNING" and first and "LAUNCHING" in ts:
            self._occ["Launching"] += n * (t - ts["LAUNCHING"])
        elif state in _END_STATES and uid not in self._ended:
            # earliest terminal stamp: a retried task records FAILED before
            # its eventual DONE, and crediting through the requeue wait
            # would overcount Running
            self._ended.add(uid)
            if "RUNNING" in ts:
                self._occ["Running"] += n * max(0.0, t - ts["RUNNING"])
        # duration model: one sample per successful completion, measured
        # from the *latest* RUNNING stamp (a retried task's requeue wait
        # must not inflate its run time).  FAILED/CANCELED leave no sample.
        if state == "RUNNING":
            self._dur_open[uid] = t
        elif state in _END_STATES:
            start = self._dur_open.pop(uid, None)
            if state == "DONE" and start is not None:
                self._dur_update(ev.get("kind") or "?", max(0.0, t - start))
        # streaming overhead union (see overhead())
        if state == "SCHEDULED":
            if uid not in self._oh_opens:
                self._oh_opens[uid] = t
                if self._oh_active == 0:
                    self._oh_ustart = t
                    self._oh_cur = 0.0
                self._oh_active += 1
        elif state in ("RUNNING",) + _END_STATES and uid in self._oh_opens:
            start = self._oh_opens.pop(uid)
            if t > start:
                self._oh_ivals.append((start, t))
            self._oh_active -= 1
            if self._oh_active == 0:
                self._oh_total += t - self._oh_ustart
                self._oh_cur = 0.0
            else:
                self._oh_cur = t - self._oh_ustart

    # ------------------------------ queries ----------------------------- #
    def completed_result(self, workflow_key: str):
        """(found, result) for a previously-DONE task with this key.
        O(1): one indexed lookup, no record scan.  A record completed
        through the data plane carries ``result_ref`` metadata instead of
        an inline value: the payload re-materializes from the object
        store's spill (the replay/restart path, docs/dataplane.md)."""
        ref = None
        with self._lock:
            rec = self._by_key.get(workflow_key)
            if rec is not None and \
                    rec.get("state") == TaskState.DONE.value:
                if "result" in rec:
                    return True, rec["result"]
                ref = rec.get("result_ref")
        if ref is not None and self.objectstore is not None:
            try:                        # client-side read: uncounted bytes
                return True, self.objectstore.get(ref["oid"])
            except (KeyError, OSError):
                pass                    # spill lost: treat as not found —
                                        # the task re-executes
        return False, None

    def states(self) -> Dict[str, str]:
        with self._lock:
            return {uid: r.get("state", "?") for uid, r in self.tasks.items()}

    def events_snapshot(self) -> List[dict]:
        """Consistent copy of the unified event stream."""
        with self._lock:
            return list(self.events)

    def timeline(self) -> Dict[str, Dict[str, float]]:
        """{uid: {state: monotonic_t}} — first occurrence of each state
        wins, matching TaskRecord stamps.  Served from the incrementally
        maintained cache (no event-stream scan)."""
        with self._lock:
            return {uid: dict(ts) for uid, ts in self._timeline.items()}

    def utilization(self, capacity: int,
                    t0: Optional[float] = None,
                    t1: Optional[float] = None) -> Dict[str, float]:
        """Fig. 6 breakdown: fraction of slot-seconds in Scheduled /
        Launching / Running / Idle over [t0, t1].  Reads the cached
        integrals — O(1) in the number of events."""
        with self._lock:
            occ = dict(self._occ)
            lo, hi = self._t_min, self._t_max
        if lo is None:
            return {"Scheduled": 0.0, "Launching": 0.0, "Running": 0.0,
                    "Idle": 1.0}
        t0 = t0 if t0 is not None else lo
        t1 = t1 if t1 is not None else hi
        total = max(capacity * (t1 - t0), 1e-12)
        scale = min(1.0, total / max(sum(occ.values()), 1e-12))
        occ = {k: v * scale for k, v in occ.items()}
        out = {k: v / total for k, v in occ.items()}
        out["Idle"] = max(0.0, 1.0 - sum(out.values()))
        return out

    def overhead(self) -> float:
        """RP overhead (this store only): wall-clock union of
        [SCHEDULED, RUNNING) intervals, maintained incrementally, plus
        any pre-compaction overhead carried by a snapshot header."""
        with self._lock:
            return self._oh_seeded + self._oh_total + self._oh_cur

    def overhead_base(self) -> float:
        """Overhead accumulated before the last journal compaction: its
        intervals were snapshotted away, only the integral survives."""
        with self._lock:
            return self._oh_seeded

    def overhead_intervals(self) -> List[Tuple[float, float]]:
        """Closed [SCHEDULED, RUNNING) intervals for cross-pilot union
        (see RPEXExecutor.rp_overhead) — one per launch attempt, so the
        multi-pilot merge unions O(tasks) intervals instead of re-deriving
        them from O(events) stream records."""
        with self._lock:
            return list(self._oh_ivals)

    # --------------------------- duration model -------------------------- #
    def _dur_update(self, kind: str, x: float):
        """Caller holds self._lock.  Fold one observed run time (seconds)
        into the per-kind EWMA mean/variance — West's exponentially
        weighted recurrence, so stale history decays instead of pinning
        the mean forever like a plain average would."""
        m = self._dur.get(kind)
        if m is None:
            self._dur[kind] = [x, 0.0, 1]
            return
        a = self._dur_alpha
        d = x - m[0]
        incr = a * d
        m[0] += incr
        m[1] = (1.0 - a) * (m[1] + d * incr)
        m[2] += 1

    def _dur_merge(self, kind: str, mean: float, var: float, n: int):
        """Caller holds self._lock (or is single-threaded replay).  Merge
        an external (mean, var, n) summary — compaction-header seeding and
        cross-pilot seeding both land here.  n-weighted moment pooling:
        the combined variance keeps the between-source spread."""
        n = int(n)
        if n <= 0:
            return
        cur = self._dur.get(kind)
        if cur is None or cur[2] <= 0:
            self._dur[kind] = [float(mean), float(var), n]
            return
        n0 = cur[2]
        tot = n0 + n
        mu = (cur[0] * n0 + float(mean) * n) / tot
        cur[1] = (n0 * (cur[1] + (cur[0] - mu) ** 2)
                  + n * (float(var) + (float(mean) - mu) ** 2)) / tot
        cur[0] = mu
        cur[2] = tot

    def duration_stats(
            self, kind: Optional[str] = None
    ) -> Optional[Tuple[float, float, int]]:
        """(ewma_mean_s, ewma_var_s2, n_samples) of observed run times for
        one app kind — or, with ``kind=None``, the n-weighted pool across
        every kind this store has seen (the pilot-level mixture estimate).
        None when there are no samples yet (cold start): callers must fall
        back, never invent a duration."""
        with self._lock:
            if kind is not None:
                m = self._dur.get(kind)
                return (m[0], m[1], m[2]) if m else None
            if not self._dur:
                return None
            n = sum(m[2] for m in self._dur.values())
            mean = sum(m[0] * m[2] for m in self._dur.values()) / n
            var = sum(m[2] * (m[1] + (m[0] - mean) ** 2)
                      for m in self._dur.values()) / n
            return (mean, var, n)

    def duration_model(self) -> Dict[str, Tuple[float, float, int]]:
        """Snapshot of the whole model, {kind: (mean, var, n)} — the
        cross-pilot seeding source (PilotPool.add_pilot)."""
        with self._lock:
            return {k: (m[0], m[1], m[2]) for k, m in self._dur.items()}

    def seed_durations(self, kind: str, mean: float, var: float, n: int):
        """Seed the model for a kind from another pilot's observations —
        a freshly spawned pilot starts warm instead of falling back to
        count-based decisions until it has its own history."""
        with self._lock:
            self._dur_merge(kind, mean, var, n)

    # --------------------------- write-behind ---------------------------- #
    def _wake_writer(self):
        if self._writer is None:
            return
        if len(self._wq) >= self._max_queue:
            # backpressure: never holds self._lock, so the writer (which
            # takes self._lock briefly when compacting) can always drain.
            # Soft-bounded: record() runs under scheduler locks (e.g. the
            # Agent's condition variable on the submit fast path), so a
            # saturated writer throttles producers briefly but must never
            # wedge them — the queue transiently overshoots instead.
            with self._wcv:
                self._wcv.notify_all()
                deadline = time.monotonic() + 0.25
                while (len(self._wq) >= self._max_queue
                       and not self._wstop
                       and time.monotonic() < deadline):
                    self._wcv.wait(0.05)
            return
        # fast path: only pay the cv acquisition when the writer is parked.
        # The unlocked flag read can race (writer parking concurrently) —
        # the writer's timed wait bounds a missed wake at ~50ms of extra
        # journal lag, never a lost record; flush()/close() always notify.
        if self._wsleeping:
            with self._wcv:
                self._wcv.notify_all()

    def _writer_loop(self):
        while True:
            with self._wcv:
                while not self._wq and not self._wstop:
                    self._wsleeping = True
                    self._wcv.wait(0.05)
                self._wsleeping = False
                batch = []
                while self._wq:
                    batch.append(self._wq.popleft())
                stop = self._wstop
                self._winflight = len(batch)
                self._wcv.notify_all()      # free any backpressured producer
            if batch:
                try:
                    self._write_batch(batch)
                    self._maybe_compact()
                except Exception as e:  # noqa: BLE001 — disk-full etc.:
                    # the journal goes dead but the store must stay live.
                    # The old synchronous path surfaced I/O errors to the
                    # caller; here the writer marks the store journal-dead
                    # (record() stops enqueuing, queue discarded) instead
                    # of dying silently and wedging producers in
                    # backpressure forever.
                    self._journal_dead(e)
                with self._wcv:
                    self._winflight = 0
                    self._wcv.notify_all()  # flush() waits on durability
            if stop:
                with self._wcv:
                    if not self._wq:        # drained: safe to exit
                        return

    def _journal_dead(self, err: Exception):
        with self._lock:
            self.journal_error = repr(err)
            if self._fh is not None:
                try:
                    self._fh.close()
                except Exception:  # noqa: BLE001
                    pass
                self._fh = None
        with self._wcv:
            self._wq.clear()
            self._wcv.notify_all()

    def _write_batch(self, batch: List[dict]):
        """Group commit: serialize the whole drain cycle, one write + one
        flush.  Records whose result had to be dropped from the line are
        also stripped from the in-memory maps — otherwise every large
        non-serializable result (e.g. device arrays) stays pinned for the
        store's lifetime, which the old synchronous probe never allowed."""
        if self._fh is None:
            return
        lines = []
        slimmed: List[dict] = []
        for rec in batch:
            ref = rec.get("result_ref")
            if ref is not None and self.objectstore is not None:
                # durable-before-event: the payload blob + .ref pointer
                # must be on disk before the DONE line that names them
                try:
                    self.objectstore.ensure_spilled(ref["oid"])
                except (KeyError, OSError,
                        serializer.SerializationError):
                    pass            # unspillable: the metadata still
                                    # journals; replay just can't
                                    # re-materialize the payload
            line, dropped = self._dumps(rec)
            lines.append(line)
            if dropped:
                slimmed.append(rec)
        if slimmed:
            with self._lock:
                for rec in slimmed:
                    rec.pop("result", None)
        try:
            self._fh.write("".join(lines))
            self._fh.flush()
        except ValueError:                  # closed mid-write during close()
            return
        self._journal_lines += len(lines)

    @staticmethod
    def _dumps(rec: dict) -> Tuple[str, bool]:
        """(journal line, result_dropped) — serialization failures fall
        back to slimmer forms instead of losing the whole record."""
        try:
            return json.dumps(rec) + "\n", False
        except (TypeError, ValueError):
            slim = {k: v for k, v in rec.items() if k != "result"}
            try:
                return json.dumps(slim) + "\n", "result" in rec
            except (TypeError, ValueError):
                return json.dumps({k: v for k, v in slim.items()
                                   if _jsonable(v)}) + "\n", "result" in rec

    def _maybe_compact(self):
        """Writer thread only: when the journal holds many times more
        lines than live task records, rewrite it as a snapshot (one line
        per task + one stats header) and keep appending — so a long
        elastic run's restart replays O(tasks), not O(transitions)."""
        threshold = max(self._compact_min_lines,
                        self._compact_factor * max(1, len(self.tasks)))
        if self._journal_lines < threshold or self._fh is None:
            return
        with self._lock:
            # Records still queued are already folded into the counters
            # and the task map being snapshotted — letting them land in
            # the tail afterwards would make a restart ingest them twice,
            # so the queue is dropped (snapshot covers it).  Runtime
            # events — flushed or queued — are re-emitted from the
            # in-memory stream so pilot-lifecycle history (PILOT_START /
            # STOLEN / GROW / PILOT_RETIRE ...) survives compaction;
            # only per-task ROUTED events are left out (high cardinality,
            # and each task record carries its "pilot" binding anyway).
            self._wq.clear()
            snap = [dict(rec, snap=True) for rec in self.tasks.values()]
            kept_events = []
            ckpt_latest: Dict[str, dict] = {}
            for e in self.events:
                kind = e.get("event")
                if kind in (None, EVENTS.STATE, EVENTS.ROUTED):
                    continue
                if kind == EVENTS.CHECKPOINT:
                    # collapse: a long task journals one CHECKPOINT per
                    # saved step, but only the latest per key is live —
                    # replay would ignore the rest anyway (monotonic
                    # steps) and gc'd keys drop out entirely, so the
                    # compacted journal carries one line per live key
                    key = e.get("key")
                    if e.get("gc"):
                        ckpt_latest.pop(key, None)
                    elif (key not in ckpt_latest
                          or e.get("step", 0)
                          >= ckpt_latest[key].get("step", 0)):
                        ckpt_latest[key] = e
                    continue
                kept_events.append(e)
            kept_events.extend(ckpt_latest.values())
            # bounded event tail: the most recent STATE events ride along
            # so recent per-task state timelines survive the compaction
            # (replay ingests them timeline-only — their aggregate
            # contribution is already inside the stats header below).
            # Each gets a wall stamp so a post-reboot replay can re-anchor
            # its monotonic time like any other journaled event.
            mono_off = time.time() - time.monotonic()
            state_evs = [e for e in self.events
                         if e.get("event") == EVENTS.STATE]
            tail = [dict(e, tail=True, wt=e["t"] + mono_off)
                    for e in state_evs[-self._compact_tail_events:]]
            stats = {"occ": dict(self._occ),
                     "oh_total": (self._oh_seeded + self._oh_total
                                  + self._oh_cur),
                     "t_min": self._t_min, "t_max": self._t_max,
                     "dur": {k: list(v) for k, v in self._dur.items()}}
        tmp = self.journal_path.with_name(self.journal_path.name
                                          + ".compact.tmp")
        with open(tmp, "w") as out:
            out.write(json.dumps({"event": EVENTS.SNAPSHOT,
                                  "t": time.monotonic(),
                                  "mono_offset": mono_off,
                                  "stats": stats}) + "\n")
            for rec in snap:
                out.write(self._dumps(rec)[0])
            for rec in kept_events:
                out.write(self._dumps(rec)[0])
            for rec in tail:
                out.write(self._dumps(rec)[0])
            out.flush()
            os.fsync(out.fileno())
        self._fh.close()
        os.replace(tmp, self.journal_path)   # atomic: never a torn journal
        self._fh = open(self.journal_path, "a")
        self._journal_lines = len(snap) + len(kept_events) + len(tail) + 1

    def flush(self, timeout: float = 10.0) -> bool:
        """Block until every queued journal record has been written.
        False on timeout — and False after a writer I/O error killed the
        journal: the queue was discarded then, so an empty queue is not
        durability and True must never claim it."""
        if self._writer is None:
            return True
        deadline = time.monotonic() + timeout
        with self._wcv:
            self._wcv.notify_all()
            while self._wq or self._winflight:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._wcv.wait(min(left, 0.05))
        return self.journal_error is None

    def close(self):
        """Drain the write-behind queue, then close the journal.  A task
        completing after close() is recorded in memory only (its journal
        write is skipped) instead of hitting a closed handle."""
        writer = self._writer
        if writer is not None:
            with self._wcv:
                self._wstop = True
                self._wcv.notify_all()
            writer.join(timeout=10.0)
            self._writer = None
        with self._lock:
            if self._fh:
                self._fh.close()
                self._fh = None


def _jsonable(x) -> bool:
    try:
        json.dumps(x)
        return True
    except (TypeError, ValueError):
        return False


def union_intervals(ivals: List[Tuple[float, float]]) -> float:
    """Total length of the union of (start, end) intervals."""
    total = 0.0
    cur_start: Optional[float] = None
    cur_end = 0.0
    for s, t in sorted(ivals):
        if cur_start is None or s > cur_end:
            if cur_start is not None:
                total += cur_end - cur_start
            cur_start, cur_end = s, t
        else:
            cur_end = max(cur_end, t)
    if cur_start is not None:
        total += cur_end - cur_start
    return total


def overhead_from_events(events: List[dict]) -> float:
    """RP overhead recomputed from a unified event stream: wall-clock
    seconds during which the runtime was placing or launching at least one
    task — the union (not the per-task sum) of every [SCHEDULED, RUNNING)
    interval observed in the stream.

    The per-task timestamp sum this replaces overcounts twice: concurrent
    launches are each charged full price even though they overlap in wall
    time, and a retried task's timestamps dict keeps only the last
    SCHEDULED/RUNNING pair, silently mixing attempts.  The event stream
    keeps every occurrence, so each attempt contributes its own interval
    and overlapping intervals are merged before integrating.  Slot-idle
    gaps between dependent tasks contribute nothing: no task is in
    SCHEDULED/LAUNCHING there, so no interval covers the gap.

    Live stores maintain this incrementally (StateStore.overhead /
    overhead_intervals); this offline form remains for synthetic streams
    and merged multi-pilot event dumps.
    """
    opens: Dict[str, float] = {}            # uid -> t of pending SCHEDULED
    ivals: List[Tuple[float, float]] = []
    for e in sorted((e for e in events if e.get("event") == EVENTS.STATE),
                    key=lambda e: e["t"]):
        uid, state, t = e["uid"], e["state"], e["t"]
        if state == "SCHEDULED":
            opens[uid] = t
        elif state in ("RUNNING",) + _END_STATES and uid in opens:
            # RUNNING closes the overhead interval; a terminal state closes
            # it too for tasks that failed before ever running
            start = opens.pop(uid)
            if t > start:
                ivals.append((start, t))
    return union_intervals(ivals)
