"""Pilot abstraction — client-side managers (the RP split kept intact).

PilotManager acquires *pilots* (device blocks held for the workload's
lifetime: the process's CUDA devices, or the devices the description
names, virtualized into slots; with ``ranks=N`` also a persistent
torch.distributed world of N rank processes that runs the pilot's spmd
tasks, spmd_world.py).  TaskManager submits translated tasks
to a pilot's Agent and tracks their futures.  The separation mirrors RP:
managers run client-side, the Agent runs "on the resource".

Heterogeneous resources enter through the PilotPool: a pool owns N pilots
with distinct PilotDescriptions (e.g. a CPU pilot for pre/post-processing
Python tasks and a device pilot for SPMD tasks).  Each description may
restrict the task kinds it accepts; the TaskManager *late-binds* every
translated task to a compatible pilot at submission time — the paper's
"heterogeneous tasks on heterogeneous resources" claim made operational.

*Which* compatible pilot is a policy question, and since PR 4 the pool
delegates it to a pluggable ``PlacementPolicy`` (see placement.py):
routing (``route``/``route_bulk``), steal-victim ordering and per-task
steal eligibility (``request_work``), and scaler template choice all ask
the policy.  ``LeastLoaded`` (the default) reproduces the PR-2 behavior
exactly; ``LocalityAware`` scores data affinity against load.

Since PR 2 the binding is no longer immutable: the pool is an active load
balancer.  When a pilot's agent goes hungry (empty wait heap, free slots)
its ``idle_cb`` asks the pool for work and the pool *steals* queued-but-
not-dispatched compatible tasks from a policy-ordered victim, re-stamping
``pilot_uid`` and emitting a STOLEN event so TaskManager bookkeeping and
journal replay stay correct.  A PoolScaler can additionally grow and
shrink the pilot set itself: it watches the unified StateStore event
streams, spawns a new pilot from a template description when queue wait
exceeds a threshold (multi-template: the policy picks the template whose
kinds match the starving queue), and drains + retires idle pilots
(PILOT_RETIRE).

Pilots are mortal (docs/resilience.md): with heartbeat supervision
enabled (``heartbeat_timeout_s``) a pool health monitor watches every
agent's liveness beat — scheduler-loop progress, probed with ``ping`` —
and declares a silent pilot LOST (``mark_lost``): a ``PILOT_LOST`` event
is journaled like PILOT_RETIRE, queued tasks re-route to survivors via
the orphan path, RUNNING checkpointable tasks re-adopt their last
durable checkpoint on the new pilot, non-checkpointable RUNNING tasks
FAIL visibly into the retry path, and the PoolScaler's replace-on-loss
trigger restores the lost capacity from a template.  Infrastructure-
failed retries (``RetryPolicy.retry_different_pilot``) also arrive here,
re-placed on a different pilot than the one whose worker or slot just
failed.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple, Union

import torch

from .agent import Agent
from .checkpoint import CheckpointStore
from .faults import PilotLost
from .futures import (ResourceSpec, TaskRecord, TaskState,
                      chain_attempt_errors, new_uid)
from .objectstore import ObjectStore
from .placement import PlacementPolicy, filter_healthy, resolve_policy
from .scheduler import SlotScheduler
from .spmd_executor import SPMDFunctionExecutor
from .spmd_world import SPMDWorld
from .store import EVENTS, StateStore
from .transport import make_transport


@dataclass
class PilotDescription:
    n_slots: int = 0                  # 0 = one slot per visible device
    devices: Optional[list] = None    # explicit device set (sub-pilot);
                                      # None = every visible CUDA device
                                      # (raises without a card: pass CPU
                                      # devices to run on the CPU)
    journal: Optional[str] = None     # StateStore journal path (restart)
    max_workers: int = 32
    cache_executables: bool = True
    backfill_window: int = 16
    straggler_factor: float = 3.0
    straggler_stdev_k: float = 4.0    # per-kind deadline spread multiplier:
                                      # deadline = max(floor, factor*mean,
                                      # mean + k*stdev) of the kind's EWMAs
    per_kind_deadlines: bool = True   # False = PR-6 global-p95 deadlines
                                      # (the knob the mixed-kind straggler
                                      # regression test pins the bug with)
    kinds: Optional[Tuple[str, ...]] = None  # accepted task/resource kinds
                                             # (e.g. ("python", "bash") or
                                             # ("spmd",)); None = accept all
    name: Optional[str] = None        # human-readable pilot label
    transport: str = "inproc"         # worker transport: "inproc" (thread
                                      # pool, default) or "proc" (worker
                                      # OS processes — python/bash bodies
                                      # run off the GIL; spmd stays local)
    worker_idle_s: float = 30.0       # pool threads idle longer than this
                                      # reap themselves (bounded pool)
    proc_start_method: Optional[str] = None  # "fork" (default) | "spawn"
    shm_threshold: Optional[int] = 256 * 1024
                                      # proc transport: ndarray args/results
                                      # at/above this size cross the worker
                                      # boundary via shared memory instead
                                      # of the pickle pipe (None disables —
                                      # the exp11 baseline)
    ranks: int = 0                    # 0 = spmd bodies run in-process;
                                      # N = on a persistent world of N rank
                                      # processes (spmd_world.py), rank r on
                                      # devices[r % len(devices)]; slots
                                      # default to one per rank


def visible_cuda_devices() -> List[torch.device]:
    """Every CUDA device this process sees.  Without a card it raises, as
    ``repro_torch.device.resolve_device`` does: a pilot never falls back to
    the CPU unless its description names CPU devices."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "PilotDescription(devices=None) means every visible CUDA device, "
            "and CUDA is not available; pass devices=[torch.device('cpu')] "
            "to run the pilot on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Pilot:
    def __init__(self, desc: PilotDescription, uid: Optional[str] = None):
        self.uid = uid or new_uid(desc.name or "pilot")
        self.desc = desc
        devices = (list(desc.devices) if desc.devices is not None
                   else visible_cuda_devices())
        n = desc.n_slots or desc.ranks or len(devices)
        self.scheduler = SlotScheduler(n)
        self.store = StateStore(desc.journal)
        self.world = (SPMDWorld(desc.ranks, devices, store=self.store,
                                owner=self.uid)
                      if desc.ranks else None)
        self.executor = SPMDFunctionExecutor(devices,
                                             cache=desc.cache_executables,
                                             world=self.world)
        self.ckpt = CheckpointStore(self.store)   # replays CHECKPOINT
        self.agent = Agent(self.scheduler, self.executor, self.store,
                           max_workers=desc.max_workers,
                           backfill_window=desc.backfill_window,
                           straggler_factor=desc.straggler_factor,
                           straggler_stdev_k=desc.straggler_stdev_k,
                           per_kind_deadlines=desc.per_kind_deadlines,
                           ckpt_store=self.ckpt,
                           transport=make_transport(
                               desc.transport, desc.max_workers,
                               idle_s=desc.worker_idle_s,
                               start_method=desc.proc_start_method,
                               shm_threshold=desc.shm_threshold)).start()
        self.objectstore = None   # pool-wired data plane (docs/dataplane.md)
        self.t_start = time.monotonic()
        self.draining = False     # a draining pilot accepts no new work
        self.lost = False         # declared LOST by health supervision:
                                  # close() must not wait on its zombies
        self._closed = False
        self.store.record_event(EVENTS.PILOT_START, pilot=self.uid, n_slots=n,
                                kinds=list(desc.kinds or ()) or None,
                                transport=desc.transport)

    # routing ----------------------------------------------------------- #
    def accepts(self, task: TaskRecord) -> bool:
        """Compatible iff the description accepts the task's kind, its
        pre-translation app kind (bash apps execute as kind="python"), or
        its stamped resource kind (None = accepts everything).  A draining
        pilot accepts nothing."""
        if self.draining:
            return False
        if self.desc.kinds is None:
            return True
        return any(k is not None and k in self.desc.kinds
                   for k in (task.kind, task.app_kind, task.res_kind))

    def load(self) -> float:
        """Demanded slots (queued + running) / capacity — the least-loaded
        routing metric."""
        return self.agent.load() / max(1, self.scheduler.capacity)

    def predicted_queue_wait(self) -> float:
        """Predicted seconds to absorb the *queued* backlog: each queued
        kind's slots priced at the duration model's EWMA mean for that
        kind (pilot-mixture fallback), spread over capacity.  0.0 with an
        empty queue — and 0.0 for kinds the model has never seen, so a
        cold pilot contributes nothing and the PoolScaler's observed-wait
        signal remains the effective floor."""
        queued = self.agent.queued_by_kind()
        if not queued:
            return 0.0
        total = 0.0
        for kind, slots in queued.items():
            st = (self.store.duration_stats(kind)
                  or self.store.duration_stats(None))
            if st is not None:
                total += slots * st[0]
        return total / max(1, self.scheduler.capacity)

    # elastic scaling --------------------------------------------------- #
    def grow(self, n_slots: int):
        self.store.record_event(EVENTS.GROW, pilot=self.uid, n=n_slots)
        return self.scheduler.grow(n_slots)

    def shrink(self, n_slots: int):
        self.store.record_event(EVENTS.SHRINK, pilot=self.uid, n=n_slots)
        return self.scheduler.shrink(n_slots)

    @property
    def n_slots(self) -> int:
        return self.scheduler.capacity

    # ----------------------------- retirement --------------------------- #
    def drain(self, timeout: float = 30.0
              ) -> List[Tuple[TaskRecord, Optional[Callable]]]:
        """Stop accepting, hand back queued tasks, finish (or preempt)
        running tasks, then close.  Returns the orphaned (task, done_cb)
        pairs for the caller to re-route elsewhere.

        RUNNING *checkpointable* tasks are cooperatively preempted: each
        unwinds at its next checkpoint boundary and joins the orphans, so
        a retiring pilot hands back partial work that resumes from its
        saved step elsewhere instead of grinding long tasks to the end.
        Tasks that fail mid-drain (e.g. an injected slot failure) requeue
        into the wait heap with no capacity left to run them, so the wait
        loop keeps sweeping the heap into the orphan list until the agent
        is empty — the pilot retires even under faults."""
        self.draining = True
        # barrier: refuse submissions from here on, so a steal racing this
        # drain is rejected (and re-placed by the pool) instead of landing
        # a task after the final sweep on an agent that will never run it
        self.agent.stop_accepting()
        preempted: List[Tuple[TaskRecord, Optional[Callable]]] = []
        plock = threading.Lock()
        collecting = [True]

        def _collect(task, cb):
            if task is None:
                return      # preempt request overtaken by a normal finish
            with plock:
                if collecting[0]:
                    preempted.append((task, cb))
                    return
            # the drain timed out and already returned: nobody will ever
            # read the orphan list, so fail the task visibly through its
            # callback rather than letting its future hang forever
            task.error = RuntimeError(
                f"pilot {self.uid} retired while task {task.uid} was "
                f"preempting")
            task.transition(TaskState.FAILED, self.store)
            if cb is not None:
                cb(task)

        orphans = list(self.agent.steal())
        # include_sticky: like the queued drain sweep, a dying pilot
        # cannot honor stickiness
        for t in self.agent.preemptable_tasks(include_sticky=True):
            self.agent.preempt(t.uid, _collect)
        deadline = time.monotonic() + timeout
        while not self.agent.wait_idle(timeout=0.1):
            orphans += self.agent.steal()
            for t in self.agent.preemptable_tasks(include_sticky=True):
                self.agent.preempt(t.uid, _collect)   # late starters
            if time.monotonic() > deadline:
                break
        with plock:
            collecting[0] = False
            orphans += preempted
        drained = self.agent.wait_idle(timeout=0)
        self.agent.shutdown(wait=False)
        if self.world is not None:
            self.world.close()
        self.store.record_event(EVENTS.PILOT_RETIRE, pilot=self.uid,
                                drained=drained)
        self.store.close()
        self._closed = True
        return orphans

    def close(self):
        if self._closed:
            return
        self._closed = True
        self.draining = True
        # a LOST pilot's outstanding count never drains (its zombie
        # bodies settle against CANCELED records, hung ones never do) —
        # don't park the pool close on it
        self.agent.shutdown(wait=not self.lost)
        if self.world is not None:
            self.world.close()          # a lost pilot's ranks are dead
        self.store.close()


def _recovery_clone(task: TaskRecord) -> TaskRecord:
    """Fresh record (same uid) for re-running a task recovered from a
    LOST pilot: the zombie body may still be executing on the lost
    pilot's workers and mutating the original record, so the survivor's
    attempt must share no mutable state with it.  The zombie's eventual
    finish settles against the CANCELED original and fires no callback
    (abandon_running popped it)."""
    return TaskRecord(
        uid=task.uid, kind=task.kind, fn=task.fn, args=task.args,
        kwargs=dict(task.kwargs), resources=task.resources,
        timestamps=dict(task.timestamps),
        depends_on=list(task.depends_on),
        retries=task.retries, max_retries=task.max_retries,
        retry_policy=task.retry_policy,
        attempt_errors=list(task.attempt_errors),
        worker_deaths=task.worker_deaths,
        res_kind=task.res_kind, app_kind=task.app_kind,
        pilot_uid=task.pilot_uid, sticky=task.sticky,
        affinity=task.affinity, affinity_bytes=task.affinity_bytes,
        checkpointable=task.checkpointable,
        ckpt_key=task.ckpt_key, inproc_only=task.inproc_only)


class PilotPool:
    """N pilots with heterogeneous descriptions + kind-aware late binding.

    The pool is also the steal coordinator and the elastic-membership
    authority: agents' idle hooks call ``request_work`` to migrate queued
    tasks off a policy-ordered victim, ``add_pilot``/``retire`` grow and
    shrink the pilot set at runtime, and migrate hooks let the TaskManager
    keep its bookkeeping (journal keys, task map) correct when a task's
    pilot binding changes after submission.  The pool is pure mechanism:
    every *which pilot* decision is delegated to ``self.policy``."""

    def __init__(self,
                 descs: Optional[Sequence[PilotDescription]] = None,
                 pilots: Optional[Sequence[Pilot]] = None,
                 steal: bool = True,
                 preempt: bool = True,
                 policy: Union[None, str, PlacementPolicy] = None,
                 heartbeat_timeout_s: Optional[float] = None,
                 heartbeat_interval_s: Optional[float] = None,
                 data_plane: bool = True,
                 data_threshold: Optional[int] = None):
        if pilots is None and descs is None:
            descs = [PilotDescription()]
        self.pilots: List[Pilot] = (list(pilots) if pilots is not None
                                    else [Pilot(d) for d in descs])
        if not self.pilots:
            raise ValueError("PilotPool needs at least one pilot")
        # the pool-wide data plane (docs/dataplane.md): task results at or
        # above the threshold are published once as ObjectRefs; spilled
        # blobs live next to the first journaled pilot's journal so they
        # survive restart with it
        self.objectstore: Optional[ObjectStore] = None
        if data_plane:
            spill = next((p.desc.journal + ".obj" for p in self.pilots
                          if p.desc.journal), None)
            self.objectstore = ObjectStore(
                spill_dir=spill,
                **({"threshold": data_threshold}
                   if data_threshold is not None else {}))
        self.retired: List[Pilot] = []
        self.steal_enabled = steal
        # preempt-and-migrate rides on the steal machinery: when a
        # queued-only pass finds nothing, a RUNNING checkpointable task
        # may be cooperatively preempted and resumed on the thief
        self.preempt_enabled = preempt
        self._preempt_inflight: Dict[str, int] = {}   # thief uid -> slots
                                                      # requested, not yet
                                                      # arrived
        self.policy = resolve_policy(policy)
        self._lock = threading.RLock()
        # moves in hand: a steal lowers the victim's outstanding count
        # before the thief's rises at submission, so ``wait_idle`` reads
        # the agents only while no move is in hand, and again if one
        # moved a task meanwhile (the epoch counts such moves)
        self._transit = threading.Condition(threading.Lock())
        self._in_transit = 0
        self._transit_epoch = 0
        self._migrate_hooks: List[Callable] = []
        self._closed = False
        self._lost_pending: List[str] = []   # LOST, not yet replaced —
                                             # PoolScaler's replace-on-
                                             # loss trigger consumes it
        # heartbeat supervision: with a timeout set, a monitor thread
        # probes every agent's liveness beat (ping + stale-age judgment)
        # and declares silent pilots LOST.  None (default) disables it.
        self._hb_timeout = heartbeat_timeout_s
        self._hb_interval = (heartbeat_interval_s
                             if heartbeat_interval_s is not None
                             else (heartbeat_timeout_s / 4.0
                                   if heartbeat_timeout_s else None))
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        for p in self.pilots:
            self._wire(p)
        if self._hb_timeout:
            self._hb_thread = threading.Thread(target=self._health_loop,
                                               daemon=True)
            self._hb_thread.start()

    def _wire(self, p: Pilot):
        if self.objectstore is not None:
            # one shared store: agents publish/materialize through it, the
            # journal spills through it, checkpoints dedupe against it
            p.objectstore = self.objectstore
            p.agent.objectstore = self.objectstore
            p.store.objectstore = self.objectstore
            p.ckpt.objectstore = self.objectstore
        if self.steal_enabled:
            p.agent.idle_cb = (
                lambda free, _p=p: self.request_work(_p, free))
        # infrastructure-failed retries prefer a different pilot: the
        # agent's retry classifier hands the attempt here instead of
        # requeueing it on the pilot whose worker or slot just failed
        p.agent.reroute_cb = (
            lambda task, cb, _p=p: self._reroute_retry(_p, task, cb))

    def __len__(self):
        with self._lock:
            return len(self.pilots)

    def active(self) -> List[Pilot]:
        with self._lock:
            return list(self.pilots)

    def all_pilots(self) -> List[Pilot]:
        """Active + retired — journal lookups and event queries must cover
        pilots that no longer exist."""
        with self._lock:
            return list(self.pilots) + list(self.retired)

    def by_uid(self, uid: str) -> Optional[Pilot]:
        return next((p for p in self.all_pilots() if p.uid == uid), None)

    def _compatible(self, task: TaskRecord) -> List[Pilot]:
        pilots = self.active()
        compat = [p for p in pilots if p.accepts(task)]
        if not compat:
            raise RuntimeError(
                f"no pilot accepts task {task.uid} "
                f"(kind={task.kind!r}, res_kind={task.res_kind!r}; pool "
                f"kinds={[p.desc.kinds for p in pilots]!r})")
        # prefer pilots whose heartbeat is fresh — a crashed or silent
        # pilot is a bad destination even before the monitor formally
        # declares it LOST.  Fall back to the unfiltered set rather than
        # refusing: mark_lost will re-route whatever lands badly.
        healthy = filter_healthy(compat, self._hb_timeout)
        return healthy or compat

    def route(self, task: TaskRecord) -> Pilot:
        """The policy's pick among pilots whose description accepts the
        task (least-loaded under the default policy)."""
        return self.policy.place(task, self._compatible(task))

    def route_bulk(self, tasks: Sequence[TaskRecord]
                   ) -> List[Union[Pilot, Exception]]:
        """Greedy policy assignment for a whole batch: the running load
        estimate includes the demand routed earlier in this batch, so a
        bulk submission spreads across compatible pilots instead of
        piling onto whichever was idle when the batch arrived.  An
        unroutable task yields its RuntimeError in place of a pilot, so
        one bad task never aborts the rest of the batch."""
        pilots = self.active()
        loads = {p.uid: p.load() for p in pilots}
        caps = {p.uid: max(1, p.scheduler.capacity) for p in pilots}
        items: List[Tuple[TaskRecord, object]] = []
        for t in tasks:
            try:
                items.append((t, self._compatible(t)))
            except RuntimeError as e:
                items.append((t, e))
        return self.policy.place_bulk(items, loads, caps)

    # --------------------------- work stealing -------------------------- #
    def add_migrate_hook(self, cb: Callable):
        """cb(task, src_pilot, dst_pilot) fires for every migrated task,
        after pilot_uid is re-stamped and before resubmission — the
        TaskManager uses it to re-record journal keys on the new pilot."""
        with self._lock:
            self._migrate_hooks.append(cb)

    def _migrate(self, task: TaskRecord, src: Pilot, dst: Pilot,
                 cb: Optional[Callable], reason: str,
                 _depth: int = 0) -> bool:
        """Move one task to dst; True iff dst actually accepted it.  The
        migrate hooks run *before* submission (the journal-key record must
        land on dst before the task can complete there), but the STOLEN
        event is only emitted for accepted migrations, so event counts
        never overstate what moved."""
        task.pilot_uid = dst.uid
        with self._lock:
            hooks = list(self._migrate_hooks)
        for h in hooks:
            h(task, src, dst)
        if task.checkpointable:
            # the checkpoint travels with the task: the destination store
            # adopts the newest snapshot (wherever a previous migration
            # left it) so ``ckpt.restore()`` works there, and every other
            # pilot drops its copy — a move, not a copy, so victim
            # journals and payload dirs never accumulate checkpoints of
            # tasks that long since migrated away
            self.ensure_checkpoint(task, dst)
        if not dst.agent.submit(task, done_cb=cb):
            # dst began draining/closing between routing and submission —
            # the agent refused rather than heaping the task, so place it
            # somewhere else (or fail it visibly if nowhere is left)
            self._place_orphan(task, cb, src, reason, _depth + 1)
            return False
        dst.store.record_event(EVENTS.STOLEN, uid=task.uid, src=src.uid,
                               dst=dst.uid, reason=reason)
        return True

    def _place_orphan(self, task: TaskRecord, cb: Optional[Callable],
                      src: Pilot, reason: str, _depth: int = 0):
        """Route a task displaced by a drain (or a refused migration) onto
        a surviving pilot — preferring pilots whose capacity can actually
        fit it, so an oversized orphan is not parked on a pilot that could
        only ever run it after a grow().  Fails the task through its
        callback when no pilot accepts it or every candidate refuses."""
        err: Optional[Exception] = None
        if _depth <= len(self.all_pilots()) + 2:
            try:
                cands = self._compatible(task)
                fitting = [p for p in cands
                           if task.resources.slots <= p.scheduler.capacity]
                dst = self.policy.place(task, fitting or cands)
                self._migrate(task, src, dst, cb, reason, _depth)
                return
            except RuntimeError as e:
                err = e
        task.error = err or RuntimeError(
            f"no pilot could take displaced task {task.uid}")
        chain_attempt_errors(task)
        task.transition(TaskState.FAILED)
        if cb is not None:
            cb(task)

    def _transit_begin(self):
        with self._transit:
            self._in_transit += 1

    def _transit_end(self, moved: bool):
        with self._transit:
            self._in_transit -= 1
            if moved:
                self._transit_epoch += 1
            self._transit.notify_all()

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Wait until no task is outstanding on any pilot and none is on
        its way between two: True if so within the timeout.  A wait over
        the agents alone can read a victim and its thief both idle in the
        gap between a steal and the thief's submission."""
        deadline = None if timeout is None else time.monotonic() + timeout

        def left():
            return (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
        while True:
            with self._transit:
                if not self._transit.wait_for(
                        lambda: self._in_transit == 0, left()):
                    return False
                epoch = self._transit_epoch
            if not all(p.agent.wait_idle(left()) for p in self.active()):
                return False
            with self._transit:
                if self._in_transit == 0 and self._transit_epoch == epoch:
                    return True
            if deadline is not None and time.monotonic() >= deadline:
                return False

    def request_work(self, thief: Pilot, free_slots: Optional[int] = None
                     ) -> int:
        """Steal queued-but-not-dispatched tasks from policy-ordered
        victims into ``thief`` (most-loaded first under the default
        policy).  Each candidate task additionally passes the policy's
        per-task ``steal_eligible`` gate — a LocalityAware policy only
        migrates a data-affine task when the victim's backlog-per-slot
        (the imbalance) beats the affinity penalty, while the hard
        ``sticky`` stamp is enforced by Agent.steal itself.  Returns
        slots' worth of work moved.  Called from agents' idle hooks
        (outside any agent lock) and from the PoolScaler."""
        if self._closed or thief.draining:
            return 0
        free = (free_slots if free_slots is not None
                else thief.scheduler.n_free)
        if free <= 0:
            return 0
        with self._lock:
            cands = [p for p in self.pilots if p is not thief]
        # snapshot demands once: queued_demand scans the victim's wait
        # heap under its cv, so don't re-pay it in the sort key and again
        # per loop iteration
        demand = {p.uid: p.agent.queued_demand() for p in cands}
        moved = 0
        for victim in self.policy.pick_victim(thief, cands, demand):
            if moved >= free:
                break
            if demand.get(victim.uid, 0) == 0:
                continue    # policy orders victims; don't assume sorted
            imbalance = (demand[victim.uid]
                         / max(1, victim.scheduler.capacity))
            self._transit_begin()
            batch = []
            try:
                batch = victim.agent.steal(
                    pred=lambda t, _th=thief, _v=victim, _imb=imbalance: (
                        _th.accepts(t)
                        and t.resources.slots <= _th.scheduler.capacity
                        and self.policy.steal_eligible(t, _th, _v, _imb)),
                    max_slots=free - moved)
                for task, cb in batch:
                    if self._migrate(task, victim, thief, cb, reason="steal"):
                        moved += task.resources.slots
            finally:
                self._transit_end(bool(batch))
        if moved == 0 and self.preempt_enabled:
            # queued-only pass found nothing movable: fall through to
            # preempt-and-migrate — a RUNNING checkpointable task can be
            # re-bound mid-flight, resuming from its saved step here
            moved += self._request_preempt(thief, free)
        return moved

    def _reserve_preempt(self, uid: str, n: int, free: int) -> bool:
        """Atomically reserve ``n`` slots of ``uid``'s preempt budget;
        False when concurrent requests already consumed it.  The check
        and the increment share one lock section — a stale read here
        would let an idle hook racing a scaler tick over-preempt past
        the thief's free capacity."""
        with self._lock:
            cur = self._preempt_inflight.get(uid, 0)
            if n > free - cur:
                return False
            self._preempt_inflight[uid] = cur + n
        return True

    def _release_preempt(self, uid: str, n: int):
        with self._lock:
            left = self._preempt_inflight.get(uid, 0) - n
            if left > 0:
                self._preempt_inflight[uid] = left
            else:
                self._preempt_inflight.pop(uid, None)

    def _request_preempt(self, thief: Pilot, free: int) -> int:
        """Pick one RUNNING checkpoint-eligible task (policy-chosen;
        sticky/replica exclusion enforced by the victim's agent) and
        request cooperative preemption: the task unwinds at its next
        checkpoint boundary and the handoff migrates it to ``thief``,
        where it resumes from the step it saved.  Returns the slots'
        worth of work *requested* — arrival is asynchronous, so an
        in-flight counter keeps repeated idle callbacks from preempting
        more work than the thief can hold."""
        with self._lock:
            inflight = self._preempt_inflight.get(thief.uid, 0)
            cands_p = [p for p in self.pilots
                       if p is not thief and not p.draining]
        budget = free - inflight
        if budget <= 0:
            return 0
        cands: List[Tuple[TaskRecord, Pilot]] = []
        loads: Dict[str, float] = {}
        for victim in cands_p:
            # preemption only pays when the victim has *queued* demand to
            # flow into the freed slots (queued yet unstolen means it is
            # pinned there: sticky, kind-incompatible, or affinity-gated).
            # Without backlog, moving a running task is pure thrash — and
            # two idle pilots would ping-pong it between them forever.
            queued = victim.agent.queued_demand()
            if queued <= 0:
                continue
            # the same imbalance currency steal_eligible is specified in:
            # queued backlog per slot of capacity (total demand would
            # count the candidate task itself and over-permit affine
            # moves the queued-steal gate refuses)
            loads[victim.uid] = queued / max(1, victim.scheduler.capacity)
            for t in victim.agent.preemptable_tasks():
                if (thief.accepts(t)
                        and t.resources.slots <= budget
                        and t.resources.slots <= thief.scheduler.capacity):
                    cands.append((t, victim))
        if not cands:
            return 0
        pick = self.policy.pick_preempt(thief, cands, loads)
        if pick is None:
            return 0
        task, victim = pick
        slots = task.resources.slots

        def handoff(t, cb, _v=victim, _th=thief, _n=slots):
            self._release_preempt(_th.uid, _n)
            if t is None:
                return      # request overtaken by a normal finish: the
                            # budget above is released, nothing migrates
            self._migrate(t, _v, _th, cb, reason="preempt")

        if not self._reserve_preempt(thief.uid, slots, free):
            return 0        # a concurrent request consumed the budget
        if not victim.agent.preempt(task.uid, handoff):
            self._release_preempt(thief.uid, slots)
            return 0
        return slots

    def rebalance(self) -> int:
        """Pull work to every hungry pilot (free slots, empty wait heap) —
        the PoolScaler's periodic safety net for idle hooks that fired
        before any sibling had a backlog."""
        moved = 0
        for p in self.active():
            if p.draining:
                continue
            free = p.scheduler.n_free
            if free > 0 and p.agent.queued_demand() == 0:
                moved += self.request_work(p, free)
        return moved

    # ------------------------- elastic membership ------------------------ #
    def add_pilot(self, desc: PilotDescription,
                  seed_durations: bool = True) -> Pilot:
        """Spawn a pilot into the live pool (records PILOT_START).

        The newcomer's duration model is seeded cross-pilot by kind from
        its siblings' observations (n-weighted merge), so an elastically
        spawned pilot makes cost-model decisions — placement pricing,
        per-kind straggler deadlines, predictive scaling — from its first
        task instead of re-learning what the fleet already measured."""
        with self._lock:
            if self._closed:
                raise RuntimeError("pool is closed")
            siblings = list(self.pilots)
            p = Pilot(desc)
            self.pilots.append(p)
        if seed_durations:
            for s in siblings:
                for kind, (mean, var, n) in s.store.duration_model().items():
                    p.store.seed_durations(kind, mean, var, n)
        self._wire(p)
        return p

    def retire(self, pilot: Pilot, timeout: float = 30.0) -> bool:
        """Drain + retire a pilot: it stops accepting work, its queued
        tasks migrate to the surviving pilots, running tasks finish, then
        it closes (records PILOT_RETIRE).  The last pilot never retires."""
        with self._lock:
            if pilot not in self.pilots or len(self.pilots) <= 1:
                return False
            self.pilots.remove(pilot)
            self.retired.append(pilot)
        self._transit_begin()
        try:
            orphans = pilot.drain(timeout=timeout)
            for task, cb in orphans:
                self._place_orphan(task, cb, pilot, reason="drain")
        finally:
            self._transit_end(True)
        self._rehost_objects(pilot)
        return True

    # -------------------------- failure domains -------------------------- #
    def mark_lost(self, pilot: Pilot, reason: str = "missed-heartbeat"
                  ) -> bool:
        """Declare a pilot LOST and recover its work onto the survivors.

        Unlike ``retire`` there is no drain: the pilot is presumed dead
        (crashed loop, silent heartbeat), so its agent is halted, queued
        tasks are stolen wholesale onto survivors, and RUNNING tasks are
        abandoned — checkpointable ones re-adopt their last durable
        snapshot on a new pilot, the rest consume a retry or fail with a
        PilotLost chained into their attempt history.  The PILOT_LOST
        event lands in the lost pilot's own journal (like PILOT_RETIRE)
        so replay after a restart sees the loss.  Returns False when the
        pilot is not an active member (already lost/retired) or the pool
        is closed."""
        with self._lock:
            if self._closed or pilot not in self.pilots:
                return False
            self.pilots.remove(pilot)
            self.retired.append(pilot)
            self._lost_pending.append(pilot.uid)
        pilot.lost = True
        pilot.draining = True
        pilot.agent.stop_accepting()
        pilot.agent.halt()
        if pilot.world is not None:
            pilot.world.kill()          # its ranks go with it
        # queued first (pred=None also sweeps the backoff-delayed heap),
        # then the abandoned RUNNING set — their zombie bodies settle
        # quietly because abandon_running already CANCELed the records
        self._transit_begin()
        try:
            queued = pilot.agent.steal()
            abandoned = pilot.agent.abandon_running()
            pilot.store.record_event(EVENTS.PILOT_LOST, pilot=pilot.uid,
                                     reason=reason, queued=len(queued),
                                     running=len(abandoned))
            for task, cb in queued:
                self._place_orphan(task, cb, pilot, reason="pilot-lost")
            for task, cb in abandoned:
                self._recover_running(task, cb, pilot)
        finally:
            self._transit_end(True)
        self._rehost_objects(pilot)
        return True

    def _rehost_objects(self, departed: Pilot):
        """Hand a departing pilot's live objects to a survivor.

        Published results the departed pilot owned stay dereferenceable:
        in-memory copies (and disk spills) live in the pool-shared store,
        so re-hosting is an ownership transfer — the survivor becomes the
        locality anchor for future byte-weighted placement and transfer
        accounting (docs/dataplane.md)."""
        if self.objectstore is None:
            return
        with self._lock:
            survivor = next((p for p in self.pilots
                             if not p.draining and not p.lost), None)
        if survivor is not None:
            n = self.objectstore.rehost(departed.uid, survivor.uid)
            if n:
                survivor.store.record_event(
                    EVENTS.OBJECTS_REHOSTED, pilot=survivor.uid,
                    src=departed.uid, objects=n)

    def _recover_running(self, task: TaskRecord, cb: Optional[Callable],
                         src: Pilot):
        """Recover one task that was RUNNING when its pilot was lost.

        The original record was CANCELed by ``abandon_running`` (its
        zombie body may still be executing in a dead worker); recovery
        operates on a fresh clone with the *same uid* so journal keys,
        checkpoint keys, and caller futures all stay valid while nothing
        mutable is shared with the zombie.  A checkpointable task resumes
        from its last durable snapshot without consuming a retry — the
        work survived, only the pilot died.  A non-checkpointable task
        lost real progress: the PilotLost counts against its retry
        budget, or fails it terminally with the full attempt history
        chained."""
        clone = _recovery_clone(task)
        err = PilotLost(
            f"pilot {src.uid} lost while {task.uid} was running")
        if clone.checkpointable:
            clone.transition(TaskState.TRANSLATED)
            self._place_orphan(clone, cb, src, reason="pilot-lost")
            return
        clone.attempt_errors.append(err)
        policy = clone.retry_policy
        fatal = policy is not None and policy.is_fatal(err)
        if not fatal and clone.retries < clone.max_retries:
            clone.retries += 1
            clone.transition(TaskState.TRANSLATED)
            self._place_orphan(clone, cb, src, reason="pilot-lost")
            return
        clone.error = err
        chain_attempt_errors(clone)
        clone.transition(TaskState.FAILED, src.store)
        if cb is not None:
            cb(clone)

    def _reroute_retry(self, src: Pilot, task: TaskRecord,
                       cb: Optional[Callable]):
        """Place an infrastructure-failed retry on a *different* pilot.

        The agent's retry classifier calls this (via ``reroute_cb``) for
        WorkerDied / PilotLost / SlotFailure attempts whose RetryPolicy
        asks for ``retry_different_pilot``: the pilot whose worker just
        died is the worst candidate for the next attempt.  Falls back to
        the orphan path (which may land back on ``src``) when no other
        pilot is compatible."""
        try:
            cands = [p for p in self._compatible(task) if p is not src]
        except RuntimeError:
            cands = []
        if cands:
            fitting = [p for p in cands
                       if task.resources.slots <= p.scheduler.capacity]
            dst = self.policy.place(task, fitting or cands)
            self._migrate(task, src, dst, cb, reason="retry")
        else:
            self._place_orphan(task, cb, src, reason="retry")

    def take_lost(self) -> List[str]:
        """Drain the pending lost-pilot uids (PoolScaler's replace-on-loss
        trigger reads this exactly once per loss)."""
        with self._lock:
            pending, self._lost_pending = self._lost_pending, []
            return pending

    def _health_loop(self):
        """Heartbeat monitor: ping agents whose beat is merely stale (a
        healthy loop re-stamps on wake, so the next probe sees a fresh
        beat) and declare LOST those that crashed or stayed silent past
        the full timeout.

        Silence counts from the first ping left unanswered, not from the
        last beat: an idle agent beats only when pinged, so a monitor that
        was itself held up (a long ``mark_lost``, a starved host) would
        otherwise find every idle pilot's beat past the timeout and
        declare healthy pilots lost."""
        asked: Dict[str, float] = {}    # uid -> first unanswered ping
        while not self._hb_stop.wait(self._hb_interval):
            for p in self.active():
                if p.draining:
                    continue
                a = p.agent
                if a.crashed:
                    self.mark_lost(p, reason="crash")
                    continue
                now = time.monotonic()
                if now - a.last_beat <= self._hb_interval:
                    asked.pop(p.uid, None)
                    continue
                since = asked.get(p.uid)
                if since is None or a.last_beat >= since:
                    asked[p.uid] = since = now      # a fresh ping
                if now - since > self._hb_timeout:
                    self.mark_lost(p, reason="missed-heartbeat")
                else:
                    a.ping()

    # ----------------------------- checkpoints --------------------------- #
    def checkpoint_step(self, key: str) -> Optional[int]:
        """Latest checkpointed step for ``key`` across every pilot's
        CheckpointStore — including retired pilots, since a migrated
        task's checkpoint lives wherever it last ran.  None when no
        checkpoint is recorded anywhere (payloads are not touched)."""
        steps = [s for p in self.all_pilots()
                 for s in [p.ckpt.step(key)] if s is not None]
        return max(steps) if steps else None

    def ensure_checkpoint(self, task: TaskRecord, dst: Pilot):
        """*Move* the newest checkpoint for the task to ``dst``: every
        other pilot's copy is adopted (max step wins — ``adopt`` keeps
        the newer side) and then discarded.  Used by migrations and by
        the restart path (a journal-replayed checkpoint may live on a
        different pilot than the one the task now routes to).  Move
        semantics keep exactly one live copy pool-wide, so completion
        GC on the final pilot retires the key everywhere and victim
        journals never accumulate stale snapshots."""
        if not task.checkpointable:
            return
        key = task.ckpt_key or task.uid
        others = [p for p in self.all_pilots() if p is not dst]
        for p in others:
            dst.ckpt.adopt(key, p.ckpt)
        for p in others:
            p.ckpt.discard(key)

    # ------------------------------ queries ------------------------------ #
    def utilization(self) -> Dict[str, float]:
        """Per-pilot busy-slot fraction across the (possibly changed)
        pilot set, keyed by pilot uid; retired pilots report 0.0."""
        return {p.uid: p.scheduler.utilization() for p in self.all_pilots()}

    def events(self) -> List[dict]:
        """Unified event stream merged across all pilots' stores,
        including retired pilots."""
        out = []
        for p in self.all_pilots():
            for e in p.store.events_snapshot():
                out.append({**e, "pilot": e.get("pilot") or p.uid})
        return sorted(out, key=lambda e: e["t"])

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            ps = list(self.pilots) + list(self.retired)
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)
        for p in ps:
            p.close()
        if self.objectstore is not None:
            self.objectstore.close()


@dataclass
class ScalerConfig:
    """PoolScaler knobs (see docs/elasticity.md, docs/placement.md).

    template          — PilotDescription cloned for every spawned pilot
                        (journal paths get a per-spawn suffix)
    templates         — multi-template scaling: the candidate descriptions
                        a scale-up chooses among; the pool's placement
                        policy picks the one whose ``kinds`` cover the
                        most starving queued demand (None = [template])
    min_pilots        — never retire below this many pilots
    max_pilots        — never spawn beyond this many pilots
    scale_up_wait_s   — spawn when the queue-wait signal exceeds this:
                        the *predicted* wait to absorb a pilot's queued
                        backlog (duration model, see docs/scheduling.md)
                        or the observed wait of its oldest queued task,
                        whichever is larger — so a long queue of slow
                        work triggers the spawn the moment it is priced,
                        not after the threshold has already been wasted
    predictive        — False restores the pure observed-wait signal
                        (PR-6 behavior); the duration model is then
                        ignored by scaling decisions
    scale_down_idle_s — retire a pilot idle (no running or queued work)
                        for this long
    spawn_cooldown_s  — minimum time between spawns, so one long queue
                        does not burst to max_pilots before the first new
                        pilot can absorb work
    interval_s        — fallback watch cadence; the scaler is otherwise
                        woken by StateStore events
    retire_spawned_only — only retire pilots the scaler itself spawned
                        (user-configured pilots are never drained)
    """
    template: PilotDescription = field(default_factory=PilotDescription)
    templates: Optional[List[PilotDescription]] = None
    min_pilots: int = 1
    max_pilots: int = 4
    scale_up_wait_s: float = 0.25
    predictive: bool = True
    scale_down_idle_s: float = 1.0
    spawn_cooldown_s: float = 0.5
    interval_s: float = 0.05
    retire_spawned_only: bool = True


class PoolScaler:
    """Elastic autoscaler: grows and shrinks the *pilot set* (not just
    slots) under load.  Watches the pools' unified StateStore event
    streams — every appended event kicks the scaler awake — and each tick
    (1) rebalances queued work onto hungry pilots, (2) spawns a pilot from
    the template when queue wait exceeds the threshold, (3) drains and
    retires pilots idle past the threshold."""

    def __init__(self, pool: PilotPool, config: Optional[ScalerConfig] = None):
        self.pool = pool
        self.cfg = config or ScalerConfig()
        self.decisions: List[dict] = []     # audit log of scale actions
        self._kick = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._spawned: Set[str] = set()
        self._idle_since: Dict[str, float] = {}
        self._watched: Set[int] = set()
        self._last_spawn = 0.0

    def start(self) -> "PoolScaler":
        self._attach()
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._kick.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    # ------------------------------ loop -------------------------------- #
    def _attach(self):
        """Subscribe to every pilot's event stream (idempotent; newly
        spawned pilots are picked up on the next tick)."""
        for p in self.pool.active():
            if id(p.store) not in self._watched:
                self._watched.add(id(p.store))
                p.store.add_listener(lambda _rec: self._kick.set())

    def _loop(self):
        while not self._stop.is_set():
            self._kick.wait(self.cfg.interval_s)
            self._kick.clear()
            if self._stop.is_set():
                return
            try:
                self._tick()
            except Exception as e:   # noqa: BLE001 — the scaler must never
                # take down the runtime; record the fault and keep watching
                self.decisions.append({"action": "error", "error": repr(e),
                                       "t": time.monotonic()})

    def _tick(self):
        self._attach()
        self.pool.rebalance()       # stealing first: it is always cheaper
        now = time.monotonic()      # than spawning a pilot

        # replace-on-loss: a LOST pilot's capacity is restored from a
        # template immediately — loss is not load, so the trigger bypasses
        # the spawn cooldown and the queue-wait threshold.  The template
        # choice still goes through the placement policy so a lost GPU
        # pilot is replaced by one whose kinds cover the starving demand.
        for lost_uid in self.pool.take_lost():
            if len(self.pool) >= self.cfg.max_pilots:
                self.decisions.append({"action": "replace_lost_skipped",
                                       "lost": lost_uid,
                                       "reason": "max_pilots", "t": now})
                continue
            starving = [kd for p in self.pool.active()
                        for kd in p.agent.queued_task_kinds()]
            template = self.pool.policy.pick_template(
                starving, self.cfg.templates or [self.cfg.template])
            p = self.pool.add_pilot(self._spawn_desc(template))
            self._spawned.add(p.uid)
            self._last_spawn = now
            self.decisions.append({"action": "replace_lost",
                                   "lost": lost_uid, "pilot": p.uid,
                                   "template": template.name, "t": now})
            self.pool.request_work(p, p.scheduler.n_free)

        pilots = self.pool.active()

        # scale up: the queue-wait signal passed the threshold even after
        # rebalancing, so no existing pilot can absorb the backlog soon.
        # The signal is *predicted* wait (queued slots priced by the
        # duration model) — a 50-task queue of known-slow work trips the
        # threshold immediately instead of after scale_up_wait_s of
        # already-wasted waiting — floored by the observed wait of the
        # oldest queued task, which covers cold models.  Which template
        # spawns is a placement decision: the policy picks the one whose
        # kinds cover the most starving queued demand.
        wait = max((self._wait_signal(p, now) for p in pilots),
                   default=0.0)
        if (wait > self.cfg.scale_up_wait_s
                and len(pilots) < self.cfg.max_pilots
                and now - self._last_spawn >= self.cfg.spawn_cooldown_s):
            starving = [kd for p in pilots
                        for kd in p.agent.queued_task_kinds()]
            template = self.pool.policy.pick_template(
                starving, self.cfg.templates or [self.cfg.template])
            p = self.pool.add_pilot(self._spawn_desc(template))
            self._spawned.add(p.uid)
            self._last_spawn = now
            self.decisions.append({"action": "scale_up", "pilot": p.uid,
                                   "template": template.name,
                                   "kinds": list(template.kinds or ())
                                   or None,
                                   "queue_wait_s": wait, "t": now})
            self.pool.request_work(p, p.scheduler.n_free)

        # scale down: drain + retire pilots idle past the threshold
        for p in pilots:
            if p.draining:
                continue
            if p.load() > 0:
                self._idle_since.pop(p.uid, None)
                continue
            since = self._idle_since.setdefault(p.uid, now)
            if (now - since >= self.cfg.scale_down_idle_s
                    and len(self.pool) > self.cfg.min_pilots
                    and (not self.cfg.retire_spawned_only
                         or p.uid in self._spawned)):
                if self.pool.retire(p):
                    self._idle_since.pop(p.uid, None)
                    self.decisions.append({"action": "retire",
                                           "pilot": p.uid, "t": now})

    def _wait_signal(self, p: Pilot, now: float) -> float:
        """Scale-up pressure from one pilot, in seconds of queue wait."""
        observed = p.agent.oldest_queued_wait(now)
        if not self.cfg.predictive:
            return observed
        return max(observed, p.predicted_queue_wait())

    def _spawn_desc(self, template: Optional[PilotDescription] = None
                    ) -> PilotDescription:
        d = template if template is not None else self.cfg.template
        n = len(self._spawned)
        return dataclasses.replace(
            d,
            name=f"{d.name or 'elastic'}{n}",
            journal=f"{d.journal}.{n}" if d.journal else None)


class PilotManager:
    def __init__(self):
        self.pilots: Dict[str, Pilot] = {}

    def submit_pilot(self, desc: PilotDescription) -> Pilot:
        p = Pilot(desc)
        self.pilots[p.uid] = p
        return p

    def submit_pilots(self, descs: Sequence[PilotDescription],
                      steal: bool = True,
                      preempt: bool = True,
                      policy: Union[None, str, PlacementPolicy] = None,
                      heartbeat_timeout_s: Optional[float] = None,
                      data_plane: bool = True,
                      data_threshold: Optional[int] = None
                      ) -> PilotPool:
        pool = PilotPool(descs=descs, steal=steal, preempt=preempt,
                         policy=policy,
                         heartbeat_timeout_s=heartbeat_timeout_s,
                         data_plane=data_plane,
                         data_threshold=data_threshold)
        for p in pool.pilots:
            self.pilots[p.uid] = p
        return pool

    def cancel(self, uid: str):
        p = self.pilots.pop(uid, None)
        if p:
            p.close()

    def close(self):
        for uid in list(self.pilots):
            self.cancel(uid)


class TaskManager:
    """Routes task descriptions to pilots' agents; tracks completion with a
    single condition variable (an event wait, not a per-task poll)."""

    def __init__(self, pool: Union[PilotPool, Pilot]):
        if isinstance(pool, Pilot):
            pool = PilotPool(pilots=[pool])
        self.pool = pool
        self.tasks: Dict[str, TaskRecord] = {}
        self._cv = threading.Condition()
        self._done: Set[str] = set()
        self._outstanding = 0
        self._wf_keys: Dict[str, str] = {}
        # keep journal replay correct under work stealing: when a task
        # migrates, its record (with the workflow key) must land on the
        # pilot that will actually run it
        self.pool.add_migrate_hook(self._on_migrate)

    def _on_migrate(self, task: TaskRecord, src: Pilot, dst: Pilot):
        key = self._wf_keys.get(task.uid)
        if key is not None:
            dst.store.record(task, workflow_key=key)

    @property
    def pilot(self) -> Pilot:
        """The primary pilot (single-pilot compatibility accessor)."""
        return self.pool.pilots[0]

    # ---------------------------- submission ---------------------------- #
    def _completion_cb(self, done_cb: Optional[Callable]):
        def _cb(t: TaskRecord):
            uid = t.uid if t.replica_of is None else t.replica_of
            self._wf_keys.pop(uid, None)    # terminal: migrations are over
            with self._cv:
                if uid not in self._done:
                    self._done.add(uid)
                    self._outstanding -= 1
                    self._cv.notify_all()
            if done_cb is not None:
                done_cb(t)
        return _cb

    def _bind(self, task: TaskRecord,
              workflow_key: Optional[str] = None,
              pilot: Optional[Pilot] = None) -> Pilot:
        """Late-bind a task to the least-loaded compatible pilot."""
        pilot = pilot if pilot is not None else self.pool.route(task)
        task.pilot_uid = pilot.uid
        self.tasks[task.uid] = task
        pilot.store.record_event(EVENTS.ROUTED, uid=task.uid, pilot=pilot.uid,
                                 kind=task.kind)
        if workflow_key is not None:
            self._wf_keys[task.uid] = workflow_key
            if task.checkpointable:
                # checkpoints of keyed tasks use the stable workflow key,
                # so a restarted run's re-submission (fresh uid) resumes
                # the interrupted task from its last saved step; the
                # routed pilot adopts the newest snapshot wherever the
                # last run left it
                if task.ckpt_key in (None, task.uid):
                    task.ckpt_key = workflow_key
                self.pool.ensure_checkpoint(task, pilot)
            pilot.store.record(task, workflow_key=workflow_key)
        return pilot

    def _fail_unroutable(self, task: TaskRecord, err: Exception,
                         done_cb: Optional[Callable]):
        """Resolve an unroutable task as FAILED through its callback — the
        submit path may run in a flush timer or dependency callback thread
        where a raised exception would be swallowed and hang the future."""
        task.error = err
        self.tasks[task.uid] = task
        task.transition(TaskState.FAILED)
        with self._cv:
            self._done.add(task.uid)
            self._cv.notify_all()        # a wait(uids=[...]) may be parked
        if done_cb is not None:
            done_cb(task)

    def submit(self, task: TaskRecord,
               done_cb: Optional[Callable] = None,
               workflow_key: Optional[str] = None) -> TaskRecord:
        cb = self._completion_cb(done_cb)
        # a routed pilot may start draining between route() and submit();
        # the agent then refuses instead of heaping the task, and we
        # simply route again (draining pilots are no longer compatible)
        for _ in range(len(self.pool.all_pilots()) + 2):
            try:
                pilot = self.pool.route(task)
            except RuntimeError as e:
                self._fail_unroutable(task, e, done_cb)
                return task
            self._bind(task, workflow_key, pilot=pilot)
            with self._cv:
                self._outstanding += 1
            task.transition(TaskState.TRANSLATED, pilot.store)
            if pilot.agent.submit(task, done_cb=cb):
                return task
            with self._cv:
                self._outstanding -= 1      # refused: unwind and retry
        self._fail_unroutable(
            task, RuntimeError(f"every pilot refused task {task.uid}"),
            done_cb)
        return task

    def submit_bulk(self, tasks: List[TaskRecord],
                    done_cb: Optional[Callable] = None,
                    workflow_keys: Optional[Dict[str, str]] = None
                    ) -> List[TaskRecord]:
        """One agent submission per pilot for a whole batch."""
        per_pilot: Dict[str, Tuple[Pilot, List[TaskRecord]]] = {}
        routed = 0
        for t, pilot in zip(tasks, self.pool.route_bulk(tasks)):
            if isinstance(pilot, Exception):
                self._fail_unroutable(t, pilot, done_cb)
                continue
            self._bind(t, (workflow_keys or {}).get(t.uid), pilot=pilot)
            per_pilot.setdefault(pilot.uid, (pilot, []))[1].append(t)
            t.transition(TaskState.TRANSLATED, pilot.store)
            routed += 1
        with self._cv:
            self._outstanding += routed
        cb = self._completion_cb(done_cb)
        for pilot, batch in per_pilot.values():
            if not pilot.agent.submit_bulk(batch, done_cb=cb):
                # the whole batch's pilot began draining mid-submission:
                # re-place each task on a surviving pilot
                for t in batch:
                    self.pool._place_orphan(t, cb, pilot, reason="reroute")
        return tasks

    # ------------------------------ waiting ------------------------------ #
    def wait(self, uids=None, timeout: Optional[float] = None) -> bool:
        """Block until the given (default: all) tasks complete — a single
        condition-variable wait, not a per-task Event scan."""
        with self._cv:
            if uids is None:
                return self._cv.wait_for(lambda: self._outstanding == 0,
                                         timeout)
            want = [u for u in uids if u in self.tasks]
            return self._cv.wait_for(
                lambda: all(u in self._done for u in want), timeout)
