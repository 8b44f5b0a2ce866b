"""DataFlowKernel — the Parsl-side engine (§II-B / Fig. 1 of the paper).

Wraps every app invocation in an AppFuture, maintains the task DAG (edges =
futures passed between apps), submits a task to its executor only when its
dependencies resolve, and tracks every task's state.

Dependency resolution is *batched* (PR 3): instead of registering one
done-callback per (consumer, dependency) edge — N lock round-trips to
launch a wide fan-in — the DFK keeps one dependency manager: each waiting
consumer holds an atomic remaining-deps counter, each producer future
carries a single DFK-level callback, and when a producer completes every
consumer it feeds is decremented in one pass under one lock.  Consumers
that become ready launch as one submit_bulk per executor in that same
pass (bulk mode) or are submitted in order (stream mode) — a 256-wide
fan-out launches in one pass, not 256 callback chains, and a wide fan-in
aggregator skips the window wait entirely (its batch is already
coalesced).  Near-simultaneous producer completions additionally
*combine*: concurrent done-callbacks enqueue their producer and return
while one drainer thread micro-batches every queued decrement pass — a
256-wide fan-in completing across agent workers costs one drain loop,
not 256 contended wakeups, and the uncontended single-producer path pays
nothing extra.

The dep manager also records *where* each producer ran: at launch, every
input future's ``pilot_uid`` becomes the consumer's data-affinity hint
(threaded through ParslTask into the translator's ``affinity`` stamp) so
a LocalityAware placement policy can put consumers next to their inputs.

Bulk window flushing is likewise a single persistent flusher thread with
one deadline per executor, replacing the fresh ``threading.Timer`` the
old code spawned per window (and its flush-vs-timer double-submit
hazard).

Two submission modes toward RPEX:
  * stream (paper's current behavior): each ready task submitted one by one;
  * bulk (paper's named future work): ready tasks are batched per tick and
    flushed with one submit_bulk call — Exp-2 measures the difference.

Restart: if the executor exposes a journaled StateStore and the DFK is given
a ``run_id``, tasks are keyed "<run_id>/<app>:<index>"; resubmitted tasks
whose key is already DONE in the journal resolve immediately from the
recorded result (checkpoint/restart at the workflow level).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .executors import Executor, ParslTask, ThreadPoolExecutor
from .futures import (AppFuture, ResourceSpec, RetryPolicy, TaskRecord,
                      TaskState, new_uid)
from .objectstore import ObjectRef, estimate_size, materialize

_current: List["DataFlowKernel"] = []


def _find_futures(obj, out=None):
    """AppFutures anywhere inside nested lists/tuples/dicts."""
    out = out if out is not None else []
    if isinstance(obj, AppFuture):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _find_futures(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _find_futures(x, out)
    return out


def _resolve(obj):
    """Substitute resolved results for futures, preserving structure
    (including NamedTuples, e.g. optimizer states).  A future holding a
    published result contributes its *ObjectRef*, not the payload — the
    edge ships a handle, and the executing pilot derefs it there (where
    cross-pilot bytes are attributable)."""
    if isinstance(obj, AppFuture):
        return obj.raw_result()
    if isinstance(obj, list):
        return [_resolve(x) for x in obj]
    if isinstance(obj, tuple):
        vals = [_resolve(x) for x in obj]
        if hasattr(obj, "_fields"):          # NamedTuple
            return type(obj)(*vals)
        return tuple(vals)
    if isinstance(obj, dict):
        return {k: _resolve(v) for k, v in obj.items()}
    return obj


def current_dfk() -> "DataFlowKernel":
    if not _current:
        raise RuntimeError("no active DataFlowKernel; use `with DataFlowKernel(...)`")
    return _current[-1]


class _DepNode:
    """A submitted-but-waiting consumer: its launch closure plus the count
    of producers it still waits on.  ``remaining`` is only touched under
    the DFK's dependency lock."""

    __slots__ = ("remaining", "launch")

    def __init__(self, remaining: int, launch: Callable):
        self.remaining = remaining
        self.launch = launch


class DataFlowKernel:
    def __init__(self, executors: Optional[Dict[str, Executor]] = None,
                 default_executor: Optional[str] = None,
                 bulk: bool = False, bulk_window: float = 0.002,
                 run_id: Optional[str] = None,
                 byte_affinity: bool = True):
        self.executors = executors or {"threads": ThreadPoolExecutor()}
        self.default_executor = default_executor or next(iter(self.executors))
        self.bulk = bulk
        self.bulk_window = bulk_window
        self.run_id = run_id
        self.byte_affinity = byte_affinity
                                    # weight data-affinity by input bytes
                                    # (False = legacy uid counting — the
                                    # exp11 placement baseline)
        self._lock = threading.Lock()
        self._invocation_idx: Dict[str, int] = {}
        self.tasks: Dict[str, TaskRecord] = {}   # DAG nodes
        self.edges: List[Tuple[str, str]] = []   # (producer, consumer)
        self.edge_bytes: List[Tuple[str, str, int]] = []
                                    # (producer uid, consumer uid, bytes)
                                    # per dataflow edge at launch time
        self.edge_bytes_total = 0
        self.t_start = time.monotonic()
        # restart observability: keys that were interrupted last run and
        # carry a checkpoint — their tasks re-execute but resume from the
        # recorded step (the value) instead of step 0
        self.resumed_from_checkpoint: Dict[str, int] = {}

        # dependency manager: producer future -> consumers waiting on it.
        # Keyed by the future object (identity), not its uid: executors
        # re-point future.task at the translated pilot task on launch, so
        # the uid is not stable between registration and completion.
        self._dep_lock = threading.Lock()
        self._consumers: Dict[AppFuture, List[_DepNode]] = {}
        # cross-producer coalescing: completed producers queue here; the
        # first completer becomes the drainer and micro-batches every
        # decrement that arrives while it drains (see _on_producer_done)
        self._producer_q: List[AppFuture] = []
        self._dep_draining = False
        self.dep_coalesced = 0      # producers combined into another
                                    # thread's drain pass (stat, tests)

        # bulk buffers + the single persistent flusher thread
        self._flush_cv = threading.Condition()
        self._pending_bulk: Dict[str, List[Tuple[ParslTask, AppFuture]]] = {}
        self._due: Dict[str, float] = {}         # label -> flush deadline
        self._flusher: Optional[threading.Thread] = None
        self._stopped = False

    # --------------------------- context mgmt --------------------------- #
    def __enter__(self):
        _current.append(self)
        return self

    def __exit__(self, *exc):
        self.shutdown()
        _current.remove(self)
        return False

    def shutdown(self):
        self.flush()
        with self._flush_cv:
            self._stopped = True
            self._flush_cv.notify_all()
        if self._flusher is not None:
            self._flusher.join(timeout=5.0)
            self._flusher = None
        self.flush()                  # anything raced in during teardown
        for ex in self.executors.values():
            ex.shutdown()

    # ----------------------------- submission --------------------------- #
    def submit(self, fn, args: tuple = (), kwargs: Optional[dict] = None,
               resources: Optional[ResourceSpec] = None, retries: int = 0,
               executor: Optional[str] = None,
               sticky: Optional[bool] = None,
               retry_policy: Optional[RetryPolicy] = None) -> AppFuture:
        kwargs = kwargs or {}
        if sticky is not None:
            # per-invocation steal-eligibility override: threaded through the
            # ResourceSpec so the translator stamps it onto the pilot task
            base = (resources or getattr(fn, "__resources__", None)
                    or ResourceSpec())
            resources = dataclasses.replace(base, sticky=sticky)
        name = getattr(fn, "__name__", "app")
        with self._lock:
            idx = self._invocation_idx.get(name, 0)
            self._invocation_idx[name] = idx + 1
        key = f"{self.run_id}/{name}:{idx}" if self.run_id else None

        # the DFK-side DAG node (distinct from the pilot-side TaskRecord the
        # translator creates later — mirrors the paper's two task objects)
        node = TaskRecord(uid=new_uid("dfk"), kind="parsl", fn=fn,
                          args=args, kwargs=kwargs,
                          resources=resources or getattr(
                              fn, "__resources__", None) or ResourceSpec())
        future = AppFuture(node)
        self.tasks[node.uid] = node

        # the executor-kind hint: explicit arg > app decorator > default
        label = (executor or getattr(fn, "__executor__", None)
                 or self.default_executor)
        ex = self.executors[label]

        # replay from journal (workflow-level restart); a multi-pilot
        # executor exposes completed_result over every pilot's journal
        lookup = getattr(ex, "completed_result", None)
        if lookup is None:
            store = getattr(getattr(ex, "pilot", None), "store", None)
            lookup = store.completed_result if store is not None else None
        if key is not None and lookup is not None:
            found, result = lookup(key)
            if found:
                node.result = result
                node.transition(TaskState.DONE)
                future.set_result(result)
                return future
            # not completed, but checkpointed: the task re-executes below
            # and its Checkpoint context restores the saved step — record
            # the partial restart so callers can see what resumed
            peek = getattr(ex, "checkpoint_step", None)
            if peek is not None:
                step = peek(key)
                if step is not None:
                    self.resumed_from_checkpoint[key] = step

        # dependency resolution: any AppFuture in args/kwargs — including
        # nested inside lists/tuples/dicts — is a dataflow edge
        inputs = _find_futures((args, kwargs))
        deps = [f for f in inputs if not f.done()]
        for d in deps:
            self.edges.append((d.uid, node.uid))
            node.depends_on.append(d.uid)

        def launch() -> Optional[Tuple[str, ParslTask, AppFuture]]:
            try:
                r_args = tuple(_resolve(a) for a in args)
                r_kwargs = {k: _resolve(v) for k, v in kwargs.items()}
            except BaseException as e:   # upstream failure propagates
                node.transition(TaskState.FAILED)
                if not future.done():
                    future.set_exception(e)
                return None
            # data-affinity hint: the pilots that produced this task's
            # inputs (every input is resolved by now, so each producer's
            # pilot binding is final — stolen tasks report the pilot that
            # actually ran them), weighted by input bytes so placement can
            # follow the *largest* input (docs/dataplane.md)
            per_pilot: Dict[str, int] = {}
            ref_oids: List[Tuple[Any, str]] = []
            edge_recs: List[Tuple[str, str, int]] = []
            for f in inputs:
                raw = f.raw_result()
                if isinstance(raw, ObjectRef):
                    size = raw.size
                    if raw._store is not None:
                        # one consumer edge per input occurrence: released
                        # when this consumer's future completes, driving
                        # the store's DONE-event ref-count GC
                        ref_oids.append((raw._store, raw.oid))
                else:
                    size = estimate_size(raw)
                puid = getattr(f.task, "pilot_uid", None)
                if puid:
                    per_pilot[puid] = per_pilot.get(puid, 0) + size
                edge_recs.append((f.task.uid, node.uid, size))
            if edge_recs:
                with self._lock:
                    self.edge_bytes.extend(edge_recs)
                    self.edge_bytes_total += sum(s for _, _, s in edge_recs)
            if self.byte_affinity:
                affinity = tuple(sorted(per_pilot, key=per_pilot.get,
                                        reverse=True))
                affinity_bytes = per_pilot or None
            else:
                affinity = tuple(dict.fromkeys(
                    p for p in (getattr(f.task, "pilot_uid", None)
                                for f in inputs) if p))
                affinity_bytes = None
            for s, oid in ref_oids:
                s.add_consumers(oid)
            if ref_oids:
                def _release(_f, _refs=tuple(ref_oids)):
                    for s, oid in _refs:
                        s.release(oid)
                future.add_done_callback(_release)
            if not getattr(self.executors[label], "resolves_refs", False):
                # executors without a data plane (e.g. the thread-pool
                # baseline) get payloads, not handles
                r_args = materialize(r_args, None)
                r_kwargs = materialize(r_kwargs, None)
            pt = ParslTask(fn, r_args, r_kwargs, node.resources, retries, key,
                           executor=label, affinity=affinity,
                           retry_policy=retry_policy,
                           affinity_bytes=affinity_bytes)
            node.transition(TaskState.TRANSLATED)
            return label, pt, future

        if not deps:
            item = launch()
            if item is not None:
                self._dispatch_ready([item], immediate=False)
            return future

        dep_node = _DepNode(len(deps), launch)
        hook: List[AppFuture] = []           # producers needing our callback
        with self._dep_lock:
            for d in deps:
                waiting = self._consumers.get(d)
                if waiting is None:
                    self._consumers[d] = [dep_node]
                    hook.append(d)
                else:
                    waiting.append(dep_node)
        for d in hook:
            d.add_done_callback(self._on_producer_done)
        for d in deps:
            # a producer that completed between registration above and its
            # callback being attached (or whose callback already drained)
            # is settled here; _on_producer_done is idempotent — each node
            # is popped and decremented at most once per registration
            if d.done():
                self._on_producer_done(d)
        return future

    # ------------------------ dependency manager ------------------------- #
    def _on_producer_done(self, fut: AppFuture):
        """One producer completed.  Producers are decremented in micro-
        batches: the completing thread enqueues its future and, if no
        drain is in flight, becomes the drainer — any producer that
        completes while it drains is combined into the same loop (its
        thread returns immediately).  A wide fan-in whose producers
        finish across N agent workers thus pays one decrement pass and
        one launch batch instead of N contended lock round-trips; the
        solitary-completion fast path is a single loop iteration with no
        handoff or window wait, keeping dependency launch latency flat."""
        with self._dep_lock:
            self._producer_q.append(fut)
            if self._dep_draining:
                self.dep_coalesced += 1
                return
            self._dep_draining = True
        try:
            while True:
                with self._dep_lock:
                    batch, self._producer_q = self._producer_q, []
                    if not batch:
                        self._dep_draining = False
                        return
                    ready = []
                    for f in batch:
                        waiting = self._consumers.pop(f, None)
                        if not waiting:
                            continue
                        for n in waiting:
                            n.remaining -= 1
                            if n.remaining == 0:
                                ready.append(n)
                if not ready:
                    continue
                items = [item for item in (n.launch() for n in ready)
                         if item is not None]
                if items:
                    # dependency-ready batches are already coalesced —
                    # submit them in this pass, not after a stream window
                    self._dispatch_ready(items, immediate=True)
        except BaseException:
            # never leave the drain flag wedged: a later completion must
            # be able to pick up whatever is still queued
            with self._dep_lock:
                self._dep_draining = False
            raise

    def _submit_batch(self, items: List[Tuple[str, ParslTask, AppFuture]]):
        """One submit_bulk per executor for a coalesced batch (stream
        submission for executors without bulk support)."""
        per_label: Dict[str, List[Tuple[ParslTask, AppFuture]]] = {}
        for label, pt, future in items:
            ex = self.executors[label]
            if ex.supports_bulk:
                per_label.setdefault(label, []).append((pt, future))
            else:
                ex.submit(pt, future)
        for label, pairs in per_label.items():
            self.executors[label].submit_bulk(pairs)

    def _dispatch_ready(self, items: List[Tuple[str, ParslTask, AppFuture]],
                        immediate: bool):
        """Route launched tasks to their executors.  An ``immediate``
        (dependency-ready) batch is already coalesced: it goes out as one
        submit_bulk per executor in the calling pass — wide fan-ins launch
        without a window wait or a flusher handoff.  Stream submissions in
        bulk mode land in the per-executor buffer, coalescing until the
        flusher thread's per-label deadline."""
        if not self.bulk:
            # stream mode never buffers — skip the flush lock entirely
            for label, pt, future in items:
                self.executors[label].submit(pt, future)
            return
        if immediate:
            self._submit_batch(items)
            return
        direct: List[Tuple[str, ParslTask, AppFuture]] = []
        now = time.monotonic()
        buffered = False
        with self._flush_cv:
            for label, pt, future in items:
                ex = self.executors[label]
                if self.bulk and ex.supports_bulk and not self._stopped:
                    self._pending_bulk.setdefault(label, []).append(
                        (pt, future))
                    if label not in self._due:
                        self._due[label] = now + self.bulk_window
                    buffered = True
                else:
                    direct.append((label, pt, future))
            if buffered:
                if self._flusher is None:
                    self._flusher = threading.Thread(
                        target=self._flusher_loop, daemon=True)
                    self._flusher.start()
                self._flush_cv.notify_all()
        for label, pt, future in direct:
            self.executors[label].submit(pt, future)

    # ------------------------------- bulk -------------------------------- #
    def _flusher_loop(self):
        """The single persistent flusher: waits until the earliest
        per-executor deadline, pops every due batch under the lock, and
        submits them outside it.  Replaces one threading.Timer per window."""
        while True:
            with self._flush_cv:
                while not self._due and not self._stopped:
                    self._flush_cv.wait()
                if self._stopped and not self._due:
                    return
                now = time.monotonic()
                due_now = [l for l, d in self._due.items() if d <= now]
                if not due_now and not self._stopped:
                    self._flush_cv.wait(min(self._due.values()) - now)
                    continue
                batches = {}
                for label in (due_now or list(self._due)):
                    pairs = self._pending_bulk.pop(label, [])
                    self._due.pop(label, None)
                    if pairs:
                        batches[label] = pairs
            for label, pairs in batches.items():
                self.executors[label].submit_bulk(pairs)

    def flush(self, executor: Optional[str] = None):
        """Flush pending bulk batches — all executors, or just one.  Safe to
        call concurrently per executor and concurrently with the flusher
        thread: each label's batch is popped under the lock, so a deadline
        flush and an explicit flush never double-submit and one executor's
        flush never blocks another's."""
        with self._flush_cv:
            labels = ([executor] if executor is not None
                      else list(self._pending_bulk))
            batches = {}
            for label in labels:
                pairs = self._pending_bulk.pop(label, [])
                if pairs:
                    batches[label] = pairs
                self._due.pop(label, None)
        for label, pairs in batches.items():
            self.executors[label].submit_bulk(pairs)

    # ------------------------------ graph ------------------------------- #
    def dag(self):
        return {"nodes": list(self.tasks), "edges": list(self.edges)}
