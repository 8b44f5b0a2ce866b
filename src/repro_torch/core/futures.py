"""Task state machine + AppFuture (the Parsl-side future abstraction).

State model follows the paper's two systems:

  Parsl/DFK states:   pending -> launched -> running -> done | failed
  RP task states:     NEW -> TRANSLATED -> SCHEDULED -> LAUNCHING ->
                      RUNNING -> DONE | FAILED | CANCELED

The RP states map 1:1 onto the resource-utilization categories of the
paper's Fig. 6 (Scheduled / Launching / Running / Idle): every transition is
timestamped in the TaskRecord so benchmarks/exp2 can integrate per-slot
timelines exactly the way the paper does.
"""
from __future__ import annotations

import itertools
import random
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Tuple

from .objectstore import ObjectRef


class TaskState(str, Enum):
    NEW = "NEW"
    TRANSLATED = "TRANSLATED"
    SCHEDULED = "SCHEDULED"
    LAUNCHING = "LAUNCHING"
    RUNNING = "RUNNING"
    DONE = "DONE"
    FAILED = "FAILED"
    CANCELED = "CANCELED"


TERMINAL = {TaskState.DONE, TaskState.FAILED, TaskState.CANCELED}

# The declared task-lifecycle state machine: every legal ``transition()``
# edge.  The static checker (repro_torch.analysis.events) verifies each
# ``transition(TaskState.X)`` site targets a reachable state; the runtime
# watchdog (REPRO_LOCK_WATCHDOG=1) validates actual from->to pairs against
# it.  Non-obvious edges, all real:
#   NEW -> NEW              translator stamps the initial state timestamp
#   NEW -> SCHEDULED        tasks submitted straight to an Agent (no
#                           translator in the loop) are NEW when placed
#   NEW -> DONE/FAILED      DFK memoization hit / upstream dep failure
#   TRANSLATED -> RUNNING   direct (non-pilot) executors skip SCHEDULED
#   RUNNING -> TRANSLATED   retry requeue before the FAILED stamp landed
#   FAILED -> TRANSLATED    retry requeue after an in-process body already
#                           stamped FAILED on the shared record
#   RUNNING -> SCHEDULED    preempt-and-migrate requeue
#   DONE -> DONE, FAILED -> FAILED   idempotent re-stamp when the agent
#                           settles a record the executor already stamped
STATE_MACHINE = {
    TaskState.NEW: (TaskState.NEW, TaskState.TRANSLATED,
                    TaskState.SCHEDULED, TaskState.RUNNING,
                    TaskState.DONE, TaskState.FAILED,
                    TaskState.CANCELED),
    TaskState.TRANSLATED: (TaskState.SCHEDULED, TaskState.RUNNING,
                           TaskState.DONE, TaskState.FAILED,
                           TaskState.CANCELED),
    TaskState.SCHEDULED: (TaskState.LAUNCHING, TaskState.SCHEDULED,
                          TaskState.TRANSLATED, TaskState.FAILED,
                          TaskState.CANCELED),
    TaskState.LAUNCHING: (TaskState.RUNNING, TaskState.FAILED,
                          TaskState.CANCELED),
    TaskState.RUNNING: (TaskState.DONE, TaskState.FAILED,
                        TaskState.CANCELED, TaskState.TRANSLATED,
                        TaskState.SCHEDULED),
    TaskState.DONE: (TaskState.DONE,),
    TaskState.FAILED: (TaskState.FAILED, TaskState.TRANSLATED),
    TaskState.CANCELED: (),
}

# Runtime transition validation hook — None (free) unless the lock-order
# watchdog is installed, which points it at its violation recorder.
_validate_transition = None

_uid = itertools.count()


def new_uid(prefix: str = "task") -> str:
    return f"{prefix}.{next(_uid):06d}"


def model_kind(task: "TaskRecord") -> str:
    """The duration-model population a task belongs to: the pre-translation
    app kind when one exists (bash apps *execute* as kind "python" but
    their run times are a bash population), else the execution kind."""
    return task.app_kind or task.kind


@dataclass(frozen=True)
class RetryPolicy:
    """Per-app retry semantics (``@python_app(retry_policy=...)``).

    ``max_retries`` additional attempts are granted after the first
    failure; each retry is requeued after an exponential backoff with
    deterministic jitter (seeded from the task uid and attempt number, so
    runs are reproducible).  The agent's retry classifier also consults:

    fatal_exceptions      — error types that short-circuit retrying: the
                            task fails terminally on the first match.
    retry_different_pilot — infrastructure failures (WorkerDied, a lost
                            pilot, an injected slot failure) send the
                            retry through the pool to a *different*
                            pilot when one is compatible; app-level
                            exceptions always retry in place.
    quarantine_after      — poison quarantine: a task whose attempts have
                            killed this many worker processes is FAILED
                            terminally (with a QUARANTINED journal event)
                            instead of respawn-storming the proc pool.
                            None disables quarantine.

    Tasks declared with the legacy ``retries=N`` (no policy) keep the old
    behavior exactly: immediate in-place requeue, no classification."""
    max_retries: int = 3
    backoff_base_s: float = 0.05    # first-retry delay; 0 = immediate
    backoff_factor: float = 2.0     # exponential growth per attempt
    backoff_max_s: float = 5.0      # delay ceiling
    jitter: float = 0.1             # +/- fraction of the delay randomized
    fatal_exceptions: Tuple[type, ...] = ()
    retry_different_pilot: bool = True
    quarantine_after: Optional[int] = 3

    def backoff_s(self, attempt: int, token: str = "") -> float:
        """Delay before retry ``attempt`` (1-based).  Jitter is seeded
        from ``(token, attempt)`` — same task, same attempt, same delay —
        so chaos runs replay deterministically."""
        if self.backoff_base_s <= 0.0:
            return 0.0
        d = min(self.backoff_max_s,
                self.backoff_base_s * self.backoff_factor ** (attempt - 1))
        if self.jitter > 0.0:
            r = random.Random(f"{token}:{attempt}")
            d *= 1.0 + self.jitter * (2.0 * r.random() - 1.0)
        return d

    def is_fatal(self, err: Optional[BaseException]) -> bool:
        return (bool(self.fatal_exceptions) and err is not None
                and isinstance(err, tuple(self.fatal_exceptions)))


def _attach_root_cause(exc: BaseException, cause: BaseException):
    """Hang ``cause`` off the *root* of ``exc``'s existing cause chain —
    pre-set causes (e.g. WorkerDied raised ``from`` a pipe EOFError) are
    preserved, not clobbered."""
    seen = {id(exc)}
    root = exc
    while root.__cause__ is not None:
        root = root.__cause__
        if id(root) in seen or root is cause:
            return
        seen.add(id(root))
    if root is not cause:
        root.__cause__ = cause


def chain_attempt_errors(task: "TaskRecord"):
    """Link the attempt-error history into the exception that will
    surface: each earlier failure becomes the ``__cause__`` of the next,
    ending at ``task.error``, so the final FAILED exception shows all N
    attempts instead of only the last."""
    prev: Optional[BaseException] = None
    for e in task.attempt_errors:
        if e is None or e is task.error or e is prev:
            continue
        if prev is not None:
            _attach_root_cause(e, prev)
        prev = e
    if prev is not None and task.error is not None:
        _attach_root_cause(task.error, prev)


@dataclass
class ResourceSpec:
    """Per-task resource requirements (the RP task-description fields Parsl
    lacks — the API extension §IV-D of the paper calls out)."""
    slots: int = 1                  # device slots (chips); MPI "ranks"
    mesh_shape: Optional[Tuple[int, int]] = None   # (data, model) sub-mesh
    cpu_only: bool = False          # pre/post-processing helper tasks
    walltime: Optional[float] = None
    priority: int = 0
    res_kind: Optional[str] = None  # resource class for pilot routing
                                    # ("cpu" | "device"); None = inferred
    sticky: bool = False            # pin to the routed pilot: never migrated
                                    # by work stealing (e.g. tasks with
                                    # pilot-local state or data affinity)
    affinity: Tuple[str, ...] = ()  # data-affinity hints: pilot uids/names
                                    # holding this task's input arrays; a
                                    # LocalityAware policy scores placement
                                    # toward them (soft, unlike sticky)
    checkpointable: bool = False    # the body accepts a ``ckpt`` keyword
                                    # (Checkpoint context): it can resume
                                    # from partial progress, making it
                                    # eligible for checkpoint-based
                                    # straggler replicas, cooperative
                                    # preempt-and-migrate, and partial
                                    # restarts

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.mesh_shape is not None:
            d, m = self.mesh_shape
            if d * m != self.slots:
                raise ValueError(
                    f"mesh_shape {self.mesh_shape} inconsistent with "
                    f"slots={self.slots}")


@dataclass
class TaskRecord:
    uid: str
    kind: str                       # python | spmd | bash
    fn: Optional[Callable] = None
    args: tuple = ()
    kwargs: dict = field(default_factory=dict)
    resources: ResourceSpec = field(default_factory=ResourceSpec)
    state: TaskState = TaskState.NEW
    timestamps: Dict[str, float] = field(default_factory=dict)
    depends_on: List[str] = field(default_factory=list)
    result: Any = None
    error: Optional[BaseException] = None
    retries: int = 0
    max_retries: int = 0
    retry_policy: Optional[RetryPolicy] = None  # translator stamp; None =
                                                # legacy immediate in-place
                                                # retries up to max_retries
    attempt_errors: List[BaseException] = field(default_factory=list)
                                    # why each prior attempt failed; the
                                    # final FAILED exception chains these
                                    # as its __cause__ ancestry
    worker_deaths: int = 0          # attempts that killed a worker
                                    # process (poison-quarantine counter)
    quarantined: bool = False       # terminally FAILED by quarantine
    slot_ids: Tuple[int, ...] = ()
    replica_of: Optional[str] = None
    res_kind: Optional[str] = None  # stamped by the translator
    app_kind: Optional[str] = None  # pre-translation kind (bash apps run
                                    # as kind="python" but route as "bash")
    pilot_uid: Optional[str] = None  # late-bound by PilotPool routing;
                                     # re-stamped if the task is stolen
    sticky: bool = False            # steal-eligibility stamp (translator)
    affinity: Tuple[str, ...] = ()  # data-affinity stamp (translator):
                                    # producer pilots + ResourceSpec hints;
                                    # scored by LocalityAware placement
    affinity_bytes: Optional[Dict[str, int]] = None
                                    # byte-weighted affinity (DFK dep
                                    # manager): input bytes per producer
                                    # pilot — placement follows the
                                    # *largest* input, and CostModelPolicy
                                    # prices the non-local remainder as
                                    # transfer seconds (docs/dataplane.md)
    checkpointable: bool = False    # translator stamp of the ResourceSpec
                                    # flag: body takes a ``ckpt`` context
    ckpt_key: Optional[str] = None  # checkpoint identity: the uid by
                                    # default; replicas share the
                                    # leader's; keyed workflows use the
                                    # stable workflow key (restart)
    ckpt_ctx: Optional[Any] = None  # live Checkpoint context while the
                                    # task executes (runtime-only, never
                                    # journaled; the executor injects it
                                    # as the body's ``ckpt`` kwarg)
    inproc_only: bool = False       # translator stamp: the body must run
                                    # in the agent's process regardless of
                                    # transport (spmd — its sub-mesh is
                                    # bound to this process's devices and
                                    # CUDA context)

    def transition(self, state: TaskState, store=None):
        if _validate_transition is not None:
            _validate_transition(self.state.value, state.value, self.uid)
        self.state = state
        self.timestamps[state.value] = time.monotonic()
        if store is not None:
            store.record(self)


class AppFuture(Future):
    """Parsl-style future: returned immediately on app invocation; reading
    the result blocks until the task completes; passing it to another app
    creates a dataflow edge."""

    def __init__(self, task: TaskRecord):
        super().__init__()
        self.task = task
        # lock-free fast read for dependency resolution: a wide fan-in
        # resolves hundreds of already-completed futures, and each
        # Future.result() pays a condition acquisition.  The stash is
        # written before the state flips to FINISHED, so any reader that
        # observed completion (e.g. via a done callback) sees it.
        self._quick: Optional[Tuple[Any]] = None

    def set_result(self, result):
        if isinstance(result, ObjectRef):
            # published result: the handle is the stored value; deref is
            # lazy (first result() call) and the materialized object then
            # takes over the lock-free stash
            super().set_result(result)
            return
        self._quick = (result,)
        super().set_result(result)

    def result(self, timeout=None):
        q = self._quick
        if q is not None:
            return q[0]
        r = super().result(timeout)
        if isinstance(r, ObjectRef):
            val = r.deref()         # client-side read: uncounted bytes
            self._quick = (val,)
            return val
        return r

    def raw_result(self):
        """Ref-or-value of a completed future: the DFK resolves consumer
        args through this so edges ship handles, not payloads — the
        actual deref happens on the *executing* pilot, where cross-pilot
        bytes are attributable.  Blocks like result() if not yet done."""
        q = self._quick
        if q is not None:
            return q[0]
        return super().result()

    def quick_result(self):
        """Result without the condition round-trip — only valid once the
        future is known to be successfully completed; falls back to
        result() (which blocks or raises) otherwise."""
        q = self._quick
        if q is not None:
            return q[0]
        return self.result()

    @property
    def uid(self) -> str:
        return self.task.uid

    def __repr__(self):
        return f"<AppFuture {self.task.uid} {self.task.state.value}>"
