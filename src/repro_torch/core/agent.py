"""Agent — the RP Agent analog: event-driven scheduler loop + worker pool.

The runtime is allocation-driven, not clock-driven: a single scheduling
thread sleeps on a condition variable and is woken only by events that can
change schedulability — task submission, slot release (via the scheduler's
listener hook), elastic grow, retry requeue, or shutdown.  There is no
polling sleep anywhere on the submit -> schedule -> run -> complete path.

Scheduled tasks are executed through a pluggable **WorkerTransport**
(transport.py) — the paper's master/worker split as a seam: the agent
schedules and keeps every piece of bookkeeping in the transport's local
pool threads; only the body call (``transport.execute``) differs by mode.
``InprocTransport`` (default) is the original persistent thread pool —
workers spawn lazily up to ``max_workers``, idle ones reap themselves
after ``worker_idle_s`` — and ``ProcessTransport`` runs python/bash
bodies in worker OS processes, off the GIL.

Scheduling keeps the priority/FIFO wait heap with bounded backfill (later
small tasks may run ahead of a blocked large task, never starving it).  A
separate monitor thread implements straggler mitigation (soft-deadline
replicas) and retry-on-failure; it waits on the stop event rather than
sleeping, so shutdown is prompt.  Replicas of *checkpointable* tasks
share the leader's checkpoint key, so they resume from the leader's
latest saved step instead of recomputing from step 0; a losing leader is
asked to unwind at its next checkpoint boundary rather than grinding on.

Cooperative preemption: ``preempt(uid, handoff)`` flags a RUNNING
checkpointable task's Checkpoint context; its next ``ckpt.save`` persists
the step then unwinds with ``TaskPreempted``, and the agent resets the
task to TRANSLATED, moves its counters off this agent (exactly like a
queued steal), and calls ``handoff(task, done_cb)`` outside all locks —
the PilotPool's preempt-and-migrate and a draining pilot's partial-work
handback are both built on this hook.

Work stealing: ``steal()`` extracts queued-but-not-dispatched tasks under
the same condition variable the scheduler loop holds for a whole pass, so
a task is either still in the wait heap (stealable, callback moves with
it) or already allocated (not stealable) — never both, never neither.
When a pass leaves the agent hungry (empty wait heap, free slots) the
``idle_cb`` hook fires outside the lock so a PilotPool can migrate work
from a loaded sibling without lock-ordering hazards.

``shutdown(wait=True)`` is an event wait on the outstanding-task counter —
it returns as soon as the agent drains (immediately when idle) and
reports the uids of any tasks stranded past the timeout.

Failure domain (docs/resilience.md): the loop stamps a liveness beat on
every wakeup — scheduler-loop progress, not thread-alive — which the
PilotPool's health monitor supervises (``ping``/``last_beat``); ``halt``
silences both loops for lost-pilot recovery and crash injection.  FAILED
tasks run through a retry classifier: a per-task ``RetryPolicy`` adds
exponential backoff with deterministic jitter (delayed requeue bounded
by the cv wait — still no polling), sends infrastructure failures
(``WorkerDied``/pilot-lost/slot-failure) to a *different* pilot via the
pool's ``reroute_cb``, short-circuits ``fatal_exceptions``, and
quarantines tasks whose attempts keep killing workers.  Every attempt's
error is kept on the record and chained (``__cause__``) into the final
FAILED exception.

All state transitions are timestamped through the StateStore's unified
event stream so the Fig.6-style utilization breakdown (Scheduled/Launching/
Running/Idle) can be integrated offline.
"""
from __future__ import annotations

import heapq
import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from .checkpoint import Checkpoint, CheckpointStore, TaskPreempted
from .faults import PilotLost, SlotFailure
from .futures import (TERMINAL, ResourceSpec, TaskRecord, TaskState,
                      chain_attempt_errors, model_kind, new_uid)
from .objectstore import materialize
from .scheduler import SlotScheduler
from .spmd_executor import SPMDFunctionExecutor
from .store import EVENTS, StateStore
from .transport import InprocTransport, WorkerDied

_log = logging.getLogger(__name__)

# errors that implicate the pilot's infrastructure rather than the task
# body: a RetryPolicy with retry_different_pilot sends these retries
# through the pool to another pilot instead of the local wait heap
_INFRA_ERRORS = (WorkerDied, PilotLost, SlotFailure)


class Agent:
    def __init__(self, scheduler: SlotScheduler,
                 executor: SPMDFunctionExecutor,
                 store: Optional[StateStore] = None,
                 max_workers: int = 32,
                 backfill_window: int = 16,
                 straggler_factor: float = 3.0,
                 straggler_min_samples: int = 5,
                 straggler_min_deadline: float = 0.1,
                 straggler_stdev_k: float = 4.0,
                 per_kind_deadlines: bool = True,
                 monitor_interval: float = 0.02,
                 poll_interval: Optional[float] = None,
                 ckpt_store: Optional[CheckpointStore] = None,
                 transport=None,
                 worker_idle_s: float = 30.0):
        self.scheduler = scheduler
        self.executor = executor
        self.store = store or StateStore()
        self.ckpt = ckpt_store or CheckpointStore(self.store)
        self.max_workers = max_workers
        self.backfill_window = backfill_window
        self.straggler_factor = straggler_factor
        self.straggler_min_samples = straggler_min_samples
        self.straggler_min_deadline = straggler_min_deadline
        self.straggler_stdev_k = straggler_stdev_k
        self.per_kind_deadlines = per_kind_deadlines
        # poll_interval is accepted for backward compatibility; the loop is
        # event-driven, so it only scales the straggler-monitor cadence.
        self.monitor_interval = (poll_interval * 10 if poll_interval
                                 else monitor_interval)

        self._cv = threading.Condition()
        self._wait: List[Tuple[int, int, TaskRecord]] = []   # heap
        self._delayed: List[Tuple[float, int, TaskRecord]] = []
                                    # backoff-delayed retries: (ready_at,
                                    # seq, task) heap; the loop's cv wait
                                    # is bounded by the earliest ready
                                    # time (deadline-driven, not polled)
        self._seq = 0
        self._running: Dict[str, TaskRecord] = {}
        self._replicas: Dict[str, str] = {}                  # replica -> orig
        self._done_cb: Dict[str, Callable] = {}
        self._ckpt_ctxs: Dict[str, Checkpoint] = {}          # uid -> live ctx
        self._preempt_handoff: Dict[str, Callable] = {}      # uid -> handoff
        self._replicated: set = set()   # originals that already got their
                                        # one replica this run attempt — a
                                        # fast-failing replica must not
                                        # trigger a respawn storm
        # recent durations only: the p95 straggler deadline needs the last
        # ~100 samples, not an unbounded re-sorted history
        self._durations: "deque[float]" = deque(maxlen=256)
        self._outstanding = 0       # submitted, not yet terminal
        self._dirty = False         # a wake event arrived for the loop
        self._stop = threading.Event()
        self._crashed = False       # chaos/lost-pilot halt: loops die
                                    # silently (no drain, no refusal)
        self._beat = time.monotonic()   # liveness beat, stamped only by
                                        # the scheduler loop itself —
                                        # heartbeat supervision judges
                                        # scheduler-loop progress, not
                                        # thread-alive
        # infra-failed retry handoff: the PilotPool wires this so a
        # WorkerDied/pilot-lost/slot-failure retry lands on a *different*
        # pilot (called outside all locks, like idle_cb)
        self.reroute_cb: Optional[
            Callable[[TaskRecord, Optional[Callable]], None]] = None
        # pool-wired data plane (docs/dataplane.md): with a store attached,
        # ObjectRef inputs are materialized here — on the *executing*
        # pilot, so transfer bytes are attributed correctly even after a
        # steal or retry — and large results are published as refs
        self.objectstore = None

        self._accepting = True      # False once draining/stopped: submit
                                    # refuses instead of heaping tasks no
                                    # scheduler thread will ever drain
        # the worker pool lives behind the transport; the agent's runner
        # (_run_task, all bookkeeping) is its per-task callback
        self.transport = (transport if transport is not None
                          else InprocTransport(max_workers, worker_idle_s))
        self.transport.start(self._run_task, executor)
        self._demand_slots = 0      # slots of all outstanding tasks (O(1)
                                    # routing load metric)
        self._queued_slots = 0      # slots of queued-but-not-dispatched
                                    # tasks (O(1) steal/scaler metric —
                                    # PoolScaler ticks and steal sorting
                                    # read it instead of scanning the heap)
        # per-app-kind splits of the two counters above: the cost-model
        # layers (CostModelPolicy, Pilot.predicted_queue_wait) price a
        # backlog as sum(slots_of_kind x predicted duration of kind), so
        # the slot counts must be available by kind without heap scans
        self._kind_demand: Dict[str, int] = {}
        self._kind_queued: Dict[str, int] = {}
        self._sched_thread = threading.Thread(target=self._loop, daemon=True)
        self._mon_thread = threading.Thread(target=self._monitor, daemon=True)
        self._started = False
        # work-request hook: called (outside all locks) with the free slot
        # count whenever a scheduling pass ends with an empty wait heap and
        # spare capacity — the PilotPool wires this to its steal coordinator
        self.idle_cb: Optional[Callable[[int], None]] = None
        self.scheduler.add_listener(self._on_capacity)

    # ------------------------------ api -------------------------------- #
    def start(self):
        if not self._started:
            self._started = True
            self._sched_thread.start()
            self._mon_thread.start()
        return self

    def submit(self, task: TaskRecord,
               done_cb: Optional[Callable] = None) -> bool:
        """Returns False (without enqueuing) when the agent no longer
        accepts work — draining or stopped — so a submission racing a
        retire is refused visibly instead of heaping a task no scheduler
        thread will ever drain."""
        with self._cv:
            if not self._accepting or self._stop.is_set():
                return False
            if done_cb is not None:
                self._done_cb[task.uid] = done_cb
            self._outstanding += 1
            self._demand_slots += task.resources.slots
            self._kadd(self._kind_demand, model_kind(task),
                       task.resources.slots)
            # fast path: nothing waiting and slots available — allocate in
            # the submitting thread and hand straight to a worker, skipping
            # the scheduler-thread handoff (one fewer context switch on the
            # hot submit->run path; priority order is vacuous on an empty
            # queue, so semantics are unchanged)
            if not self._wait:
                slots = self.scheduler.allocate(task.uid,
                                                task.resources.slots)
                if slots is not None:
                    task.slot_ids = slots
                    task.transition(TaskState.SCHEDULED, self.store)
                    self._running[task.uid] = task
                    self._dispatch(task)
                    return True
            heapq.heappush(self._wait,
                           (-task.resources.priority, self._seq, task))
            self._seq += 1
            self._queued_slots += task.resources.slots
            self._kadd(self._kind_queued, model_kind(task),
                       task.resources.slots)
            self._dirty = True
            self._cv.notify_all()
            return True

    def submit_bulk(self, tasks, done_cb: Optional[Callable] = None) -> bool:
        """Bulk submission (the paper's named future work): one lock
        acquisition and one wakeup for a whole batch, cutting per-task
        submission overhead.  False if the agent no longer accepts work
        (nothing enqueued).

        Fast path (mirrors submit()): with an empty wait heap the batch is
        allocated inline in the submitting thread, in the same descending-
        priority order a fresh scheduling pass would use, skipping the
        scheduler-thread handoff; the first task that does not fit (and
        everything after it) is heaped for the event-driven loop."""
        with self._cv:
            if not self._accepting or self._stop.is_set():
                return False
            pending = list(tasks)
            if not self._wait:
                pending.sort(key=lambda t: -t.resources.priority)  # stable
                cut = None
                for i, t in enumerate(pending):
                    slots = self.scheduler.allocate(t.uid, t.resources.slots)
                    if slots is None:
                        cut = i
                        break
                    if done_cb is not None:
                        self._done_cb[t.uid] = done_cb
                    self._outstanding += 1
                    self._demand_slots += t.resources.slots
                    self._kadd(self._kind_demand, model_kind(t),
                               t.resources.slots)
                    t.slot_ids = slots
                    t.transition(TaskState.SCHEDULED, self.store)
                    self._running[t.uid] = t
                    self._dispatch(t)
                pending = [] if cut is None else pending[cut:]
            for t in pending:
                self._enqueue(t, done_cb)
            if pending:
                self._cv.notify_all()
            return True

    def stop_accepting(self):
        """Refuse all future submissions (the drain barrier): called
        before a drain's final queue sweep so no racing steal can land a
        task after the sweep."""
        with self._cv:
            self._accepting = False

    def _enqueue(self, task: TaskRecord, done_cb: Optional[Callable]):
        """Caller holds self._cv."""
        if done_cb is not None:
            self._done_cb[task.uid] = done_cb
        heapq.heappush(self._wait,
                       (-task.resources.priority, self._seq, task))
        self._seq += 1
        self._outstanding += 1
        self._demand_slots += task.resources.slots
        self._queued_slots += task.resources.slots
        kind = model_kind(task)
        self._kadd(self._kind_demand, kind, task.resources.slots)
        self._kadd(self._kind_queued, kind, task.resources.slots)
        self._dirty = True

    def shutdown(self, wait: bool = True, timeout: float = 60.0
                 ) -> List[str]:
        """Returns the uids of tasks still outstanding when the drain
        wait timed out (empty when drained, or with ``wait=False``) — a
        hung body is diagnosable instead of silently abandoned.  The
        stranded set is also logged and journaled (SHUTDOWN_STRANDED)."""
        stranded: List[str] = []
        if self._stop.is_set() or self._crashed:
            # the scheduler loop is already gone: queued work can never
            # drain, so a repeated (or post-crash) shutdown must not park
            # on the full drain timeout
            wait = False
        if wait:
            with self._cv:
                drained = self._cv.wait_for(
                    lambda: self._outstanding == 0, timeout)
                if not drained:
                    stranded = sorted(
                        {t.uid for t in self._running.values()
                         if t.state not in TERMINAL}
                        | {t.uid for _, _, t in self._wait
                           if t.state not in TERMINAL}
                        | {t.uid for _, _, t in self._delayed
                           if t.state not in TERMINAL})
            if stranded:
                _log.warning(
                    "Agent.shutdown: %d task(s) still outstanding after "
                    "%.1fs drain wait: %s", len(stranded), timeout,
                    ", ".join(stranded))
                self.store.record_event(EVENTS.SHUTDOWN_STRANDED,
                                        count=len(stranded),
                                        uids=stranded[:32])
        with self._cv:
            # set under the cv so the submit fast path can never observe
            # "not stopped"; the scheduler thread joins before the pool is
            # poisoned, so no dispatch can race a shutting-down transport
            self._stop.set()
            self._cv.notify_all()
        if self._started:
            self._sched_thread.join(timeout=5.0)   # no more dispatches after
            self._mon_thread.join(timeout=5.0)
        self.transport.shutdown()
        return stranded

    # --------------------------- failure domain -------------------------- #
    @property
    def crashed(self) -> bool:
        return self._crashed

    @property
    def last_beat(self) -> float:
        """Monotonic stamp of the scheduler loop's last observed progress
        (wakeup or scheduling pass).  Goes stale when the loop is wedged
        or crashed — the PilotPool health monitor's loss signal."""
        return self._beat

    def ping(self):
        """Ask the scheduler loop for a fresh liveness beat: wakes it
        without marking work dirty; a healthy loop re-stamps ``last_beat``
        on the wakeup, a wedged one leaves it to age out."""
        with self._cv:
            self._cv.notify_all()

    def halt(self):
        """Silence the scheduler and monitor loops without draining,
        refusing, or notifying anyone — the lost-pilot recovery path (and
        crash injection) uses this; running bodies become zombies whose
        eventual finishes settle quietly against CANCELED records."""
        with self._cv:
            self._crashed = True
            self._cv.notify_all()

    def inject_crash(self):
        """Chaos hook: simulate the whole pilot dying — loops stop
        silently, heartbeats go stale, and the PilotPool health monitor
        is expected to declare the pilot LOST and recover its tasks."""
        self.halt()

    def abandon_running(self
                        ) -> List[Tuple[TaskRecord, Optional[Callable]]]:
        """Detach every RUNNING task from this agent (the lost-pilot
        sweep): records flip to CANCELED so the zombie bodies' eventual
        finishes settle quietly without firing callbacks or retrying;
        live checkpoint contexts get a preempt request so checkpointable
        bodies unwind at their next save instead of grinding on.  Returns
        (task, done_cb) pairs for non-replica tasks — the pool re-runs
        them elsewhere from a fresh clone of each record."""
        out: List[Tuple[TaskRecord, Optional[Callable]]] = []
        with self._cv:
            victims = list(self._running.values())
            ctxs = list(self._ckpt_ctxs.values())
            handoffs = list(self._preempt_handoff.values())
            self._preempt_handoff.clear()
            for t in victims:
                if t.state in TERMINAL:
                    continue
                cb = self._done_cb.pop(t.uid, None)
                t.transition(TaskState.CANCELED, self.store)
                if t.replica_of is None:
                    out.append((t, cb))
        for h in handoffs:
            h(None, None)       # release any reserved preempt budget
        for ctx in ctxs:
            ctx.request_preempt()
        return out

    def inject_slot_failure(self, slots):
        """Simulate node failure: victims are FAILED then retried elsewhere."""
        victims = self.scheduler.mark_failed(slots)
        with self._cv:
            for uid in victims:
                t = self._running.get(uid)
                if t is not None:
                    t.error = SlotFailure(f"slot failure on {slots}")
        return victims

    @staticmethod
    def _kadd(counts: Dict[str, int], kind: str, n: int):
        """Caller holds self._cv.  Adjust a per-kind slot counter, dropping
        zeroed entries so a long-lived agent never accretes dead kinds."""
        new = counts.get(kind, 0) + n
        if new > 0:
            counts[kind] = new
        else:
            counts.pop(kind, None)

    def load(self) -> int:
        """Slot demand (queued + running) — the PilotPool routing metric.
        An O(1) counter read, maintained at submit/terminal transitions."""
        with self._cv:
            return self._demand_slots

    def demand_by_kind(self) -> Dict[str, int]:
        """Per-app-kind split of ``load()``: {kind: outstanding slots}.
        O(#kinds) copy of incrementally maintained counters — the cost
        model prices this backlog as sum(slots x predicted duration)."""
        with self._cv:
            return dict(self._kind_demand)

    def queued_by_kind(self) -> Dict[str, int]:
        """Per-app-kind split of ``queued_demand()`` (the stealable,
        not-yet-dispatched backlog) — the PoolScaler's predictive wait
        signal prices exactly this, since running tasks keep their slots
        regardless of how many pilots exist."""
        with self._cv:
            return dict(self._kind_queued)

    def queued_demand(self) -> int:
        """Slots demanded by queued-but-not-dispatched tasks (the stealable
        backlog).  An O(1) counter read maintained at enqueue / dispatch /
        steal, so PoolScaler ticks and steal-victim sorting no longer scan
        the wait heap under the scheduler's condition variable.  A task
        that turns terminal while queued keeps its slots counted until the
        next scheduling pass or steal sweeps it — the same staleness
        window ``_demand_slots`` (load()) has always had."""
        with self._cv:
            return max(0, self._queued_slots)

    def queued_task_kinds(self) -> List[Tuple[Tuple[str, ...], int]]:
        """One entry per queued-but-not-dispatched task: (the identifiers
        it routes under — kind, pre-translation app kind, resource kind —
        deduplicated, None dropped; its slot demand).  The PoolScaler
        aggregates these across pilots into the starving-queue signal the
        placement policy's ``pick_template`` matches against when more
        than one scale-up template is configured."""
        with self._cv:
            return [
                (tuple(dict.fromkeys(
                    k for k in (t.kind, t.app_kind, t.res_kind)
                    if k is not None)),
                 t.resources.slots)
                for _, _, t in self._wait if t.state not in TERMINAL]

    def oldest_queued_wait(self, now: Optional[float] = None) -> float:
        """Seconds the longest-waiting queued task has sat unscheduled —
        the PoolScaler's scale-up signal.  0.0 when the queue is empty."""
        now = now if now is not None else time.monotonic()
        with self._cv:
            ts = [t.timestamps.get("TRANSLATED",
                                   t.timestamps.get("NEW", now))
                  for _, _, t in self._wait if t.state not in TERMINAL]
        return max(0.0, now - min(ts)) if ts else 0.0

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Event-wait until every submitted task reached a terminal state
        (or was stolen away).  True if drained within the timeout."""
        with self._cv:
            return self._cv.wait_for(lambda: self._outstanding == 0, timeout)

    # ---------------------------- work stealing -------------------------- #
    def steal(self, pred: Optional[Callable[[TaskRecord], bool]] = None,
              max_tasks: Optional[int] = None,
              max_slots: Optional[int] = None
              ) -> List[Tuple[TaskRecord, Optional[Callable]]]:
        """Steal-safe queue extraction: atomically remove queued-but-not-
        dispatched tasks (latest-submitted first, classic steal-from-the-
        tail) together with their completion callbacks.

        Runs under the same condition variable `_schedule_pass` holds for a
        whole pass, so a task racing a dispatch is observed on exactly one
        side: still queued (stolen, never dispatched here) or already
        allocated (kept, never stolen).  Outstanding/demand counters move
        with the task, so `shutdown(wait=True)` and `load()` stay correct
        on the victim.  Sticky tasks and straggler replicas are never
        handed out (replicas' first-finisher-wins bookkeeping is pilot-
        local) — ``sticky`` is the *hard* eligibility pin enforced here,
        while soft placement-policy gates (e.g. LocalityAware's
        affinity-vs-imbalance test) arrive composed into ``pred`` by the
        pool; `pred=None` takes everything else (the drain path).
        """
        taken: List[Tuple[TaskRecord, Optional[Callable]]] = []
        with self._cv:
            if not self._wait and not (pred is None and self._delayed):
                return taken
            keep: List[Tuple[int, int, TaskRecord]] = []
            slots_left = max_slots if max_slots is not None else float("inf")
            # FIFO order is ascending (-priority, seq); walk the tail first
            for item in sorted(self._wait, reverse=True):
                _, _, t = item
                if t.state in TERMINAL:
                    # canceled while queued: settle in place, as the
                    # scheduling pass would have
                    self._done_cb.pop(t.uid, None)
                    self._outstanding -= 1
                    self._demand_slots -= t.resources.slots
                    self._queued_slots -= t.resources.slots
                    kind = model_kind(t)
                    self._kadd(self._kind_demand, kind, -t.resources.slots)
                    self._kadd(self._kind_queued, kind, -t.resources.slots)
                    continue
                eligible = (t.replica_of is None
                            and (pred is None
                                 or (not t.sticky and pred(t)))
                            and (max_tasks is None or len(taken) < max_tasks)
                            and t.resources.slots <= slots_left)
                if not eligible:
                    keep.append(item)
                    continue
                taken.append((t, self._done_cb.pop(t.uid, None)))
                slots_left -= t.resources.slots
                self._outstanding -= 1
                self._demand_slots -= t.resources.slots
                self._queued_slots -= t.resources.slots
                kind = model_kind(t)
                self._kadd(self._kind_demand, kind, -t.resources.slots)
                self._kadd(self._kind_queued, kind, -t.resources.slots)
            keep.sort()
            self._wait = keep                    # sorted list is a valid heap
            if pred is None and self._delayed:
                # the drain path must also sweep backoff-delayed retries —
                # moving to another pilot waives the remaining backoff
                # (delayed tasks are never in _queued_slots, so only the
                # outstanding/demand counters move)
                still: List[Tuple[float, int, TaskRecord]] = []
                for item in self._delayed:
                    _, _, t = item
                    if t.state in TERMINAL:
                        self._done_cb.pop(t.uid, None)
                        self._outstanding -= 1
                        self._demand_slots -= t.resources.slots
                        self._kadd(self._kind_demand, model_kind(t),
                                   -t.resources.slots)
                        continue
                    if ((max_tasks is not None and len(taken) >= max_tasks)
                            or t.resources.slots > slots_left):
                        still.append(item)
                        continue
                    taken.append((t, self._done_cb.pop(t.uid, None)))
                    slots_left -= t.resources.slots
                    self._outstanding -= 1
                    self._demand_slots -= t.resources.slots
                    self._kadd(self._kind_demand, model_kind(t),
                               -t.resources.slots)
                heapq.heapify(still)
                self._delayed = still
            if self._outstanding == 0:
                self._cv.notify_all()            # a shutdown wait may park
        return taken

    # ------------------------ cooperative preemption --------------------- #
    def preemptable_tasks(self, include_sticky: bool = False
                          ) -> List[TaskRecord]:
        """RUNNING tasks eligible for cooperative preempt-and-migrate:
        checkpointable (the saved step travels, so no work is lost), not
        ``sticky`` (the hard pin applies to running tasks too — except
        under ``include_sticky``, the drain path: a dying pilot cannot
        honor stickiness), not a replica and not a replicated leader
        (first-finisher-wins bookkeeping is pilot-local), and with no
        preempt already pending."""
        with self._cv:
            leaders = set(self._replicas.values())
            return [t for uid, t in self._running.items()
                    if t.checkpointable
                    and (include_sticky or not t.sticky)
                    and t.replica_of is None and uid not in leaders
                    and uid in self._ckpt_ctxs
                    and uid not in self._preempt_handoff
                    and t.state == TaskState.RUNNING]

    def preempt(self, uid: str, handoff: Callable) -> bool:
        """Request cooperative preemption of a RUNNING checkpointable
        task.  Its next ``ckpt.save`` persists the step and unwinds with
        ``TaskPreempted``; the agent then resets the task to TRANSLATED,
        moves its outstanding/demand counters off this agent (exactly
        like a queued steal), and calls ``handoff(task, done_cb)``
        outside all locks.  If the task instead reaches a normal finish
        first, the pending request is dropped and the handoff is called
        once with ``(None, None)`` so the requester can release whatever
        it reserved for the migration.  False when the task is not
        running here, has no live Checkpoint context yet, or a preempt
        is already pending — by construction a handed-off task always
        has a saved checkpoint (the raise happens *after* the save)."""
        with self._cv:
            t = self._running.get(uid)
            ctx = self._ckpt_ctxs.get(uid)
            if (t is None or ctx is None or t.replica_of is not None
                    or uid in self._preempt_handoff):
                return False
            self._preempt_handoff[uid] = handoff
        ctx.request_preempt()
        return True

    # --------------------------- scheduling ----------------------------- #
    def _on_capacity(self):
        """Scheduler listener: slots were released or grown — wake the loop."""
        with self._cv:
            self._dirty = True
            self._cv.notify_all()

    def _loop(self):
        while True:
            with self._cv:
                while (not self._dirty and not self._stop.is_set()
                       and not self._crashed):
                    # liveness beat: stamped only here and below, by the
                    # scheduler loop itself on every wakeup — a wedged or
                    # crashed loop goes visibly stale to the health monitor
                    self._beat = time.monotonic()
                    if self._delayed:
                        # bound the wait by the earliest backoff deadline:
                        # delayed-retry promotion is deadline-driven, not
                        # polled
                        wait_s = self._delayed[0][0] - time.monotonic()
                        if wait_s <= 0.0:
                            self._promote_delayed()
                            continue
                        self._cv.wait(wait_s)
                    else:
                        self._cv.wait()
                    self._promote_delayed()
                if self._stop.is_set() or self._crashed:
                    return
                self._dirty = False
                self._beat = time.monotonic()
            self._schedule_pass()
            self._maybe_request_work()

    def _promote_delayed(self):
        """Caller holds self._cv: move backoff-delayed retries whose
        ready time has arrived into the wait heap (and into the queued
        counters they were excluded from while parked)."""
        now = time.monotonic()
        while self._delayed and self._delayed[0][0] <= now:
            _, _, t = heapq.heappop(self._delayed)
            if t.state in TERMINAL:      # canceled while backing off
                self._done_cb.pop(t.uid, None)
                self._outstanding -= 1
                self._demand_slots -= t.resources.slots
                self._kadd(self._kind_demand, model_kind(t),
                           -t.resources.slots)
                if self._outstanding == 0:
                    self._cv.notify_all()
                continue
            heapq.heappush(self._wait,
                           (-t.resources.priority, self._seq, t))
            self._seq += 1
            self._queued_slots += t.resources.slots
            self._kadd(self._kind_queued, model_kind(t),
                       t.resources.slots)
            self._dirty = True

    def _maybe_request_work(self):
        """After a pass: if the wait heap is empty and slots are free, ask
        the pool for work.  Called with no locks held — the hook steals
        from a sibling agent (its cv) then submits here (our cv), and
        holding ours across that would invert the lock order."""
        cb = self.idle_cb
        if cb is None:
            return
        with self._cv:
            hungry = not self._wait and not self._stop.is_set()
        if hungry:
            free = self.scheduler.n_free
            if free > 0:
                cb(free)

    def _schedule_pass(self):
        with self._cv:
            window = []
            rest = []
            launched = False
            while self._wait and len(window) < self.backfill_window:
                window.append(heapq.heappop(self._wait))
            for item in window:
                _, _, t = item
                if t.state in TERMINAL:      # canceled while queued
                    self._outstanding -= 1
                    self._demand_slots -= t.resources.slots
                    self._queued_slots -= t.resources.slots
                    kind = model_kind(t)
                    self._kadd(self._kind_demand, kind, -t.resources.slots)
                    self._kadd(self._kind_queued, kind, -t.resources.slots)
                    if self._outstanding == 0:
                        self._cv.notify_all()
                    continue
                slots = self.scheduler.allocate(t.uid, t.resources.slots)
                if slots is None:
                    rest.append(item)        # backfill: keep trying later ones
                    continue
                t.slot_ids = slots
                self._queued_slots -= t.resources.slots
                self._kadd(self._kind_queued, model_kind(t),
                           -t.resources.slots)
                t.transition(TaskState.SCHEDULED, self.store)
                self._running[t.uid] = t
                self._dispatch(t)
                launched = True
            for item in rest:
                heapq.heappush(self._wait, item)
            if launched and self._wait:
                # progress was made and work remains: run another pass (a
                # blocked-only pass instead waits for a capacity event)
                self._dirty = True

    def _dispatch(self, task: TaskRecord):
        """Hand a scheduled task to the transport's worker pool (which
        grows lazily until it covers all claimed work, so tasks scheduled
        in one pass run concurrently).  Caller holds self._cv; the
        transport takes only its own pool lock and never calls back into
        the agent from under it, so the ordering is acyclic."""
        self.transport.dispatch(task)

    # ---------------------------- execution ----------------------------- #
    def _run_task(self, task: TaskRecord):
        task.transition(TaskState.LAUNCHING, self.store)
        if self.objectstore is not None:
            # deref ObjectRef inputs on the executing pilot: same-pilot
            # edges hand over the in-memory object (zero copies),
            # cross-pilot edges fetch once, cache, and count bytes_moved.
            # The overwrite is deliberate — a later retry re-ships values,
            # which is correct (the ref may be GC'd by then).
            task.args = materialize(task.args, self.objectstore,
                                    task.pilot_uid)
            task.kwargs = materialize(task.kwargs, self.objectstore,
                                      task.pilot_uid)
        ctx = None
        if task.checkpointable:
            ctx = Checkpoint(self.ckpt, task.ckpt_key or task.uid)
            task.ckpt_ctx = ctx         # the executor injects it as the
            with self._cv:              # body's ``ckpt`` kwarg
                self._ckpt_ctxs[task.uid] = ctx
        try:
            try:
                if task.kind == "spmd":
                    # materialize the sub-mesh + specialized callable now
                    # so LAUNCHING captures compile cost (the ibrun
                    # analog)...
                    mesh = self.executor.submesh(task.slot_ids,
                                                 task.resources.mesh_shape)
                task.transition(TaskState.RUNNING, self.store)
                t0 = time.monotonic()
                result = self.transport.execute(task)
                dt = time.monotonic() - t0
                if task.error is not None:     # slot failed mid-flight
                    raise task.error
            finally:
                # clear the context BEFORE any finish path can requeue or
                # hand off the task: its next run installs a fresh
                # context (possibly immediately, on another worker or
                # agent), and this worker must never clobber it
                if ctx is not None:
                    if task.ckpt_ctx is ctx:
                        task.ckpt_ctx = None
                    with self._cv:
                        if self._ckpt_ctxs.get(task.uid) is ctx:
                            del self._ckpt_ctxs[task.uid]
            if self.objectstore is not None:
                # publish once: at/above the store threshold the result
                # becomes an ObjectRef owned by this pilot; consumers
                # deref lazily (docs/dataplane.md)
                result = self.objectstore.maybe_publish(result,
                                                        task.pilot_uid)
            task.result = result
            self._finish(task, TaskState.DONE, dt)
        except TaskPreempted:
            self._preempt_finish(task)
        except BaseException as e:   # noqa: BLE001 — agent must survive
            task.error = e
            self._finish(task, TaskState.FAILED, None)

    def _finish(self, task: TaskRecord, state: TaskState, duration):
        self.scheduler.release(task.uid)      # fires _on_capacity listener
        with self._cv:
            self._running.pop(task.uid, None)
            handoff = self._preempt_handoff.pop(task.uid, None)
            if duration is not None:
                self._durations.append(duration)
            orig_uid = self._replicas.pop(task.uid, None)
        if handoff is not None:
            # a pending preempt was overtaken by a normal finish: notify
            # the requester with (None, None) so it can release whatever
            # it reserved for the migration (e.g. the pool's in-flight
            # preempt budget for the thief)
            handoff(None, None)

        if task.state == TaskState.CANCELED:
            # a replica already answered for this task and canceled it —
            # don't retry, don't overwrite CANCELED, don't re-fire callbacks
            if task.checkpointable:
                # GC any checkpoint this leader re-saved after the
                # winning replica's discard
                self.ckpt.discard(task.ckpt_key or task.uid)
            self._settle(task)
            return

        # replica bookkeeping — checked BEFORE the retry path: a FAILED
        # replica with retries remaining used to fall into the generic
        # retry requeue *after* its _replicas mapping was popped, turning
        # it into an ordinary task — first-finisher-wins bookkeeping was
        # lost, a later success canceled nothing, and it kept running
        # after the original completed.  Failed replicas are dropped,
        # never retried (the original is still running and retries on its
        # own terms).  First finisher wins, the loser is canceled; a
        # failed replica must NOT consume the original's callback.
        if orig_uid is not None:
            if state == TaskState.DONE:
                cb = self._done_cb.pop(orig_uid, None)
                with self._cv:
                    orig = self._running.get(orig_uid)
                    octx = self._ckpt_ctxs.get(orig_uid)
                task.transition(state, self.store)
                if cb is not None:
                    cb(task)
                if orig is not None:
                    orig.transition(TaskState.CANCELED, self.store)
                    if octx is not None:
                        # a checkpointing leader unwinds at its next save
                        # instead of grinding a canceled task to the end
                        octx.request_preempt()
                if task.checkpointable:
                    self.ckpt.discard(task.ckpt_key or orig_uid)
            else:
                task.transition(state, self.store)
            self._settle(task)
            return

        if state == TaskState.FAILED:
            err = task.error
            policy = task.retry_policy
            if isinstance(err, WorkerDied):
                # poison tracking: this attempt took a worker process down
                task.worker_deaths += 1
            fatal = policy is not None and policy.is_fatal(err)
            quarantined = (policy is not None
                           and policy.quarantine_after is not None
                           and task.worker_deaths >= policy.quarantine_after)
            if quarantined and not task.quarantined:
                # the task's attempts keep killing workers: fail it
                # terminally instead of respawn-storming the proc pool
                task.quarantined = True
                self.store.record_event(
                    EVENTS.QUARANTINED, uid=task.uid, pilot=task.pilot_uid,
                    worker_deaths=task.worker_deaths,
                    attempts=task.retries + 1,
                    error=repr(err)[:200] if err is not None else None)
            if (not fatal and not quarantined
                    and task.retries < task.max_retries):
                task.retries += 1
                if err is not None:
                    task.attempt_errors.append(err)   # history, not a wipe:
                                                      # the final failure
                                                      # chains all attempts
                task.error = None
                task.slot_ids = ()
                # a checkpointable retry resumes from its last saved step —
                # the checkpoint is only discarded on DONE
                task.transition(TaskState.TRANSLATED, self.store)
                reroute = self.reroute_cb
                if (reroute is not None and policy is not None
                        and policy.retry_different_pilot
                        and isinstance(err, _INFRA_ERRORS)):
                    # infrastructure fault: this pilot's workers/slots are
                    # suspect — hand the retry to the pool, which places
                    # it on a different pilot.  Hand off BEFORE
                    # decrementing (the _preempt_finish invariant): a
                    # drain observing outstanding == 0 must already see
                    # the task on its new pilot, never lose it between.
                    cb = self._done_cb.pop(task.uid, None)
                    with self._cv:
                        self._replicated.discard(task.uid)
                    reroute(task, cb)
                    with self._cv:
                        self._outstanding -= 1
                        self._demand_slots -= task.resources.slots
                        self._kadd(self._kind_demand, model_kind(task),
                                   -task.resources.slots)
                        if self._outstanding == 0:
                            self._cv.notify_all()
                    return
                delay = (policy.backoff_s(task.retries, task.uid)
                         if policy is not None else 0.0)
                with self._cv:                # requeue keeps it outstanding
                    self._replicated.discard(task.uid)   # fresh attempt:
                                                         # may straggle anew
                    if delay > 0.0:
                        # parked off the wait heap until the backoff
                        # deadline; the loop's cv wait is bounded by it
                        heapq.heappush(self._delayed,
                                       (time.monotonic() + delay,
                                        self._seq, task))
                    else:
                        heapq.heappush(
                            self._wait,
                            (-task.resources.priority, self._seq, task))
                        self._queued_slots += task.resources.slots
                        self._kadd(self._kind_queued, model_kind(task),
                                   task.resources.slots)
                        self._dirty = True
                    self._seq += 1
                    self._cv.notify_all()
                return
            if task.attempt_errors:
                # surface the whole history: earlier attempts become the
                # __cause__ ancestry of the final exception
                chain_attempt_errors(task)

        task.transition(state, self.store)
        if state == TaskState.DONE and task.checkpointable:
            self.ckpt.discard(task.ckpt_key or task.uid)   # payload GC
        cb = self._done_cb.pop(task.uid, None)
        if cb is not None:
            cb(task)
        self._settle(task)

    def _preempt_finish(self, task: TaskRecord):
        """A checkpointable body unwound with TaskPreempted: the step it
        just saved is durable, so the task is reset to TRANSLATED and
        either handed off (preempt-and-migrate / drain) or requeued
        locally.  Counters move with the task exactly as in steal()."""
        self.scheduler.release(task.uid)
        with self._cv:
            self._running.pop(task.uid, None)
            handoff = self._preempt_handoff.pop(task.uid, None)
            orig_uid = self._replicas.pop(task.uid, None)

        if task.state == TaskState.CANCELED or orig_uid is not None:
            # a canceled leader unwound early via the preempt flag (its
            # replica already answered and consumed the callback), or a
            # stray replica: settle quietly, and GC the checkpoint the
            # leader may have re-saved after the winner's discard
            if task.state != TaskState.CANCELED:
                task.transition(TaskState.CANCELED, self.store)
            if task.checkpointable:
                self.ckpt.discard(task.ckpt_key or task.uid)
            self._settle(task)
            return

        cb = self._done_cb.pop(task.uid, None)
        task.error = None
        task.slot_ids = ()
        task.transition(TaskState.TRANSLATED, self.store)
        if handoff is not None:
            # hand off BEFORE decrementing: a drain observing
            # outstanding == 0 must already see this task in its orphan
            # sweep, never lose it in the window between the two
            handoff(task, cb)
            with self._cv:
                self._outstanding -= 1
                self._demand_slots -= task.resources.slots
                self._kadd(self._kind_demand, model_kind(task),
                           -task.resources.slots)
                if self._outstanding == 0:
                    self._cv.notify_all()
            return
        # no handoff registered (the requester raced a drain or vanished):
        # requeue locally — the next pass or steal picks it up
        with self._cv:
            if cb is not None:
                self._done_cb[task.uid] = cb
            heapq.heappush(self._wait,
                           (-task.resources.priority, self._seq, task))
            self._seq += 1
            self._queued_slots += task.resources.slots
            self._kadd(self._kind_queued, model_kind(task),
                       task.resources.slots)
            self._dirty = True
            self._cv.notify_all()

    def _settle(self, task: TaskRecord):
        """One submitted record reached a terminal state."""
        with self._cv:
            self._replicated.discard(task.uid)
            self._outstanding -= 1
            self._demand_slots -= task.resources.slots
            self._kadd(self._kind_demand, model_kind(task),
                       -task.resources.slots)
            if self._outstanding == 0:
                self._cv.notify_all()

    # ----------------------------- monitor ------------------------------ #
    def _deadline(self, kind: Optional[str] = None) -> Optional[float]:
        """Straggler deadline in seconds, or None while too cold to judge.

        Per-kind first (the tentpole fix): with ``kind`` given and enough
        samples in the store's duration model, the deadline is
        ``max(floor, factor x mean, mean + k x stdev)`` of *that kind's*
        population — so one fast kind's flood can no longer drag the
        global p95 below a slow kind's normal runtime and spawn spurious
        replicas (replica churn burns slots the cost model then
        mis-reads).  Cold kinds — and ``per_kind_deadlines=False`` — fall
        back to the original global recent-p95 x factor."""
        if kind is not None and self.per_kind_deadlines:
            stats = self.store.duration_stats(kind)
            if stats is not None and stats[2] >= self.straggler_min_samples:
                mean, var, _n = stats
                return max(self.straggler_min_deadline,
                           mean * self.straggler_factor,
                           mean + self.straggler_stdev_k * var ** 0.5)
        with self._cv:
            if len(self._durations) < self.straggler_min_samples:
                return None
            # slice the deque (most recent 100) BEFORE sorting: sorting
            # first and then slicing took the 100 *largest* of up to 256
            # samples — once the deque exceeded 100 entries the "p95"
            # drifted toward the all-time max, inflating the straggler
            # deadline until replicas effectively stopped firing
            xs = sorted(list(self._durations)[-100:])
            p95 = xs[max(0, int(len(xs) * 0.95) - 1)]
            # floor: now that the p95 tracks recent (possibly sub-ms)
            # durations again, micro-task workloads would otherwise trip
            # deadlines shorter than the monitor's own sampling cadence —
            # a replica there costs more than the task it duplicates
            return max(p95 * self.straggler_factor,
                       self.straggler_min_deadline)

    def _monitor(self):
        # stop-event wait, not a sleep: exits promptly on shutdown and never
        # touches the submit->schedule->complete path.
        while not self._stop.wait(self.monitor_interval):
            if self._crashed:
                return               # the pilot "died": no replicas either
            now = time.monotonic()
            with self._cv:
                running = [
                    t for t in self._running.values()
                    if t.state == TaskState.RUNNING
                    and t.uid not in self._replicated
                    and t.replica_of is None
                    and t.uid not in self._preempt_handoff]
            # one deadline per kind per tick (duration-model read, outside
            # the cv): each task is judged against its own population
            dl_by_kind: Dict[str, Optional[float]] = {}
            for t in running:
                kind = model_kind(t)
                if kind not in dl_by_kind:
                    dl_by_kind[kind] = self._deadline(kind)
                dl = dl_by_kind[kind]
                if (dl is not None
                        and now - t.timestamps.get("RUNNING", now) > dl
                        and self.scheduler.n_free >= t.resources.slots):
                    self._spawn_replica(t)

    def _spawn_replica(self, t: TaskRecord) -> TaskRecord:
        """Submit a straggler replica of a RUNNING task.  The record
        keeps every stamp the translator put on the original — sticky,
        affinity, res/app kind, pilot binding — so the replica's journal
        and placement records match the original's (they used to be
        dropped, so replica records lost the translator's stamps).
        Sharing ``ckpt_key`` is what makes replicas checkpoint-based:
        the replica's ``ckpt.restore()`` picks up the leader's latest
        saved step and resumes there instead of recomputing from 0.

        One replica per original per run attempt (``_replicated``): a
        replica that fails instantly must not trigger a respawn storm —
        the deadline would re-trip on every monitor tick for as long as
        the leader keeps running.  The marker clears if the original
        itself fails and requeues (a fresh attempt may straggle anew)."""
        rep = TaskRecord(
            uid=new_uid("replica"), kind=t.kind, fn=t.fn,
            args=t.args, kwargs=t.kwargs, resources=t.resources,
            replica_of=t.uid, res_kind=t.res_kind, app_kind=t.app_kind,
            pilot_uid=t.pilot_uid, sticky=t.sticky, affinity=t.affinity,
            affinity_bytes=t.affinity_bytes,
            max_retries=t.max_retries,
            checkpointable=t.checkpointable,
            ckpt_key=t.ckpt_key or t.uid)
        with self._cv:
            self._replicas[rep.uid] = t.uid
            self._replicated.add(t.uid)
        rep.transition(TaskState.TRANSLATED, self.store)
        if not self.submit(rep):
            # the agent stopped accepting (drain/stop) between the
            # deadline check and here: roll the bookkeeping back, or the
            # stale _replicas entry would mark the leader as replicated
            # forever — e.g. excluding it from the drain's own
            # preempt-and-handback sweep
            with self._cv:
                self._replicas.pop(rep.uid, None)
                self._replicated.discard(t.uid)
        return rep

    # ------------------------------ stats ------------------------------- #
    def utilization_timeline(self):
        """Per-task state intervals for the Fig.6-style breakdown, derived
        from the StateStore's unified event stream."""
        return self.store.timeline()
