"""Task checkpointing — cooperative partial restarts for long tasks.

The straggler-replica and preempt-and-migrate mechanisms both need the
same primitive: the ability to re-run a long task *from where it got to*
instead of from step 0.  This module provides it in two pieces:

  * ``CheckpointStore`` — a per-pilot checkpoint registry journaled
    through the pilot's StateStore: every ``save``/``discard`` appends a
    ``CHECKPOINT`` event (write-behind, like all runtime events), so a
    restarted pilot replays its checkpoint map from the journal.  Payloads
    are pickled to a ``<journal>.ckpt/`` directory next to the journal —
    written atomically (tmp + ``os.replace``) *before* the event is
    queued, so a replayed event never references a torn payload; a crash
    between the two loses only that one checkpoint, never corrupts the
    map.  Journal-less stores keep payloads in memory only.  Compaction
    keeps one CHECKPOINT line per live key (see ``StateStore``), and
    ``discard`` unlinks the payload and journals a ``gc`` marker so
    completed tasks' checkpoints do not accumulate.

  * ``Checkpoint`` — the per-execution context handed to a checkpointable
    task body as the ``ckpt`` keyword argument, and the runtime's
    cooperative-preemption boundary: when the agent has requested
    preemption, the next ``ckpt.save(step, state)`` persists the step and
    then raises ``TaskPreempted``, so the body unwinds having lost
    nothing and the runtime can requeue, migrate, or restart it to
    ``restore()`` from exactly that step.

Checkpoints are keyed by ``TaskRecord.ckpt_key`` — the task uid by
default, shared by straggler replicas (so a replica resumes from the
leader's progress) and replaced by the stable workflow key when the task
is submitted through a keyed workflow (so a restarted run resumes an
interrupted task mid-stream).  Steps are monotonic per key: a stale
writer (e.g. a canceled leader unwinding behind its replica) can never
roll a checkpoint back.
"""
from __future__ import annotations

import os
import pickle
import re
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

from .objectstore import BlobLeaf
from .store import EVENTS, StateStore

try:
    import numpy as _np
except ImportError:                     # pragma: no cover - numpy is a
    _np = None                          # hard dep everywhere else

_SAFE = re.compile(r"[^A-Za-z0-9._-]")


class TaskPreempted(BaseException):
    """Raised inside a task body by ``Checkpoint.save`` when the agent
    has requested cooperative preemption: the step just saved is durable,
    so unwinding here forfeits no work.  Derives from ``BaseException``
    so a task body's own ``except Exception`` error handling cannot
    accidentally swallow the unwind."""

    def __init__(self, key: str, step: int):
        super().__init__(f"preempted at checkpoint {key!r} step {step}")
        self.key = key
        self.step = step


class CheckpointStore:
    """Journal-backed checkpoint registry (one per pilot; see module
    docstring for the durability model)."""

    def __init__(self, store: StateStore):
        self.store = store
        self.objectstore = None         # pool-wired data plane: large
                                        # ndarray leaves persist as
                                        # content-addressed BlobLeaf refs
                                        # deduped against result spills
                                        # (docs/dataplane.md)
        self._lock = threading.Lock()
        # key -> {"step": int, "state": Any (if in memory), "path": str?}
        self._latest: Dict[str, dict] = {}
        self.dir: Optional[Path] = None
        if store.journal_path is not None:
            self.dir = store.journal_path.with_name(
                store.journal_path.name + ".ckpt")
            self.dir.mkdir(parents=True, exist_ok=True)
        # replay: a journaled store has already rebuilt its event stream,
        # including CHECKPOINT events, by the time we attach
        for ev in store.events_snapshot():
            if ev.get("event") == EVENTS.CHECKPOINT:
                self._ingest(ev)

    def _ingest(self, ev: dict):
        key = ev.get("key")
        if key is None:
            return
        if ev.get("gc"):
            self._latest.pop(key, None)
            return
        cur = self._latest.get(key)
        if cur is None or ev.get("step", 0) >= cur["step"]:
            self._latest[key] = {"step": ev.get("step", 0),
                                 "path": ev.get("path")}

    # ------------------------------- api -------------------------------- #
    def save(self, key: str, step: int, state: Any) -> bool:
        """Record ``state`` as the checkpoint for ``step``.  Returns False
        (recording nothing) when a newer step is already held — steps are
        monotonic per key, so a lagging duplicate writer cannot roll the
        checkpoint back."""
        path = self._persist(key, step, state)
        with self._lock:
            cur = self._latest.get(key)
            prev = cur.get("path") if cur else None
            if cur is not None and cur["step"] > step:
                stale, accepted = path, False
            elif path is None and prev is not None:
                # the new state could not be pickled: keep the previous
                # durable payload (its journaled event must keep pointing
                # at a real file — a post-crash replay resumes from it)
                # and carry its path forward so a later successful save
                # still GCs it
                stale = None
                self._latest[key] = {"step": step, "state": state,
                                     "path": prev}
                accepted = True
            else:
                stale = None if prev == path else prev
                self._latest[key] = {"step": step, "state": state,
                                     "path": path}
                accepted = True
        self._unlink(stale)            # payload GC: one live file per key
        if accepted and (self.dir is None or path is not None):
            # journaled stores only record events whose payload actually
            # landed on disk: an unpicklable state is a memory-only
            # checkpoint, and replaying its event would make step()
            # assert a resume that restore() can never deliver
            self.store.record_event(EVENTS.CHECKPOINT, key=key, step=step,
                                    path=path)
        return accepted

    def step(self, key: str) -> Optional[int]:
        """Latest recorded step for ``key`` without touching the payload
        (the cheap existence probe restart observability uses)."""
        with self._lock:
            cur = self._latest.get(key)
            return None if cur is None else cur["step"]

    def has(self, key: str) -> bool:
        with self._lock:
            return key in self._latest

    def latest(self, key: str) -> Optional[Tuple[int, Any]]:
        """(step, state) of the newest checkpoint, or None.  Replayed
        entries lazy-load their payload from disk (and cache it); a
        missing or unreadable payload means no usable checkpoint."""
        with self._lock:
            cur = self._latest.get(key)
            if cur is None:
                return None
            if "state" in cur:
                return cur["step"], cur["state"]
            step, path = cur["step"], cur.get("path")
        if not path or not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as fh:
                state = pickle.load(fh)
            state = self._rehydrate(state)
        except Exception:  # noqa: BLE001 — unreadable payload (or a
            return None    # missing leaf blob): no resume
        with self._lock:
            cur = self._latest.get(key)
            if cur is not None and cur["step"] == step:
                cur["state"] = state
        return step, state

    def discard(self, key: str):
        """GC a completed task's checkpoint: drop the entry, unlink the
        payload, and journal a ``gc``-marked CHECKPOINT event so replay
        and compaction drop the key too."""
        with self._lock:
            cur = self._latest.pop(key, None)
        if cur is None:
            return
        self._unlink(cur.get("path"))
        self.store.record_event(EVENTS.CHECKPOINT, key=key, gc=True)

    def adopt(self, key: str, src: "CheckpointStore") -> bool:
        """Copy ``src``'s latest checkpoint for ``key`` into this store
        (the migrate-hook path: the checkpoint travels with the task)
        unless ours is already at least as new.  Steps are compared
        first (lock-only on both sides) so the steady-state no-op —
        e.g. ``ensure_checkpoint`` probing every pilot on each keyed
        submission — never touches the payload."""
        if src is self:
            return False
        src_step = src.step(key)
        if src_step is None:
            return False
        with self._lock:
            cur = self._latest.get(key)
            if cur is not None and cur["step"] >= src_step:
                return False
        got = src.latest(key)
        if got is None:
            return False
        return self.save(key, got[0], got[1])

    def keys(self):
        with self._lock:
            return list(self._latest)

    # ----------------------------- payloads ----------------------------- #
    def _persist(self, key: str, step: int, state: Any) -> Optional[str]:
        """Write the payload next to the journal, atomically, *before*
        the CHECKPOINT event is recorded — a replayed event always points
        at a fully-written file.  Unpicklable state falls back to a
        memory-only checkpoint (usable within this process; a restart
        then starts the task from scratch)."""
        if self.dir is None:
            return None
        name = f"{_SAFE.sub('_', key)}.{step}.pkl"
        # per-writer tmp name: a leader and its checkpoint-resumed
        # replica share the key by design and may save the same step
        # concurrently — interleaved writes into one shared tmp would
        # let os.replace promote a torn payload
        tmp = self.dir / f"{name}.{threading.get_ident()}.tmp"
        final = self.dir / name
        try:
            state = self._dehydrate(state)
            with open(tmp, "wb") as fh:
                pickle.dump(state, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, final)
            return str(final)
        except Exception:  # noqa: BLE001
            try:
                tmp.unlink()
            except OSError:
                pass
            return None

    @staticmethod
    def _unlink(path: Optional[str]):
        if path:
            try:
                os.unlink(path)
            except OSError:
                pass

    # ------------------------- per-leaf blobs --------------------------- #
    def _dehydrate(self, state: Any, _depth: int = 0) -> Any:
        """Replace large ndarray leaves with content-addressed BlobLeaf
        refs through the pool object store: the pickled skeleton stays
        small, and a leaf byte-identical to a published result (or
        repeated across steps/keys) lands on disk exactly once.  Without
        a wired object store this is the identity (the PR-7 whole-pickle
        path)."""
        store = self.objectstore
        if store is None or _np is None:
            return state
        if (isinstance(state, _np.ndarray) and not state.dtype.hasobject
                and state.nbytes >= store.threshold):
            try:
                sha, size = store.put_blob(state)
            except Exception:  # noqa: BLE001 — unspillable leaf: inline
                return state
            return BlobLeaf(sha, size,
                            f"ndarray[{state.dtype}]{state.shape}")
        if _depth >= 3:
            return state
        if isinstance(state, dict):
            return {k: self._dehydrate(v, _depth + 1)
                    for k, v in state.items()}
        if isinstance(state, list):
            return [self._dehydrate(v, _depth + 1) for v in state]
        if isinstance(state, tuple):
            out = [self._dehydrate(v, _depth + 1) for v in state]
            if hasattr(state, "_fields"):       # NamedTuple
                return type(state)(*out)
            return tuple(out)
        return state

    def _rehydrate(self, state: Any, _depth: int = 0) -> Any:
        """Inverse of ``_dehydrate``: load BlobLeaf refs back from the
        object store's blob namespace.  A missing blob raises — the
        caller treats the checkpoint as unusable."""
        if isinstance(state, BlobLeaf):
            if self.objectstore is None:
                raise RuntimeError(
                    "checkpoint contains BlobLeaf refs but no object "
                    "store is wired")
            return self.objectstore.get_blob(state.sha)
        if _depth >= 3:
            return state
        if isinstance(state, dict):
            return {k: self._rehydrate(v, _depth + 1)
                    for k, v in state.items()}
        if isinstance(state, list):
            return [self._rehydrate(v, _depth + 1) for v in state]
        if isinstance(state, tuple):
            out = [self._rehydrate(v, _depth + 1) for v in state]
            if hasattr(state, "_fields"):       # NamedTuple
                return type(state)(*out)
            return tuple(out)
        return state


class Checkpoint:
    """Per-execution checkpoint context (the ``ckpt`` keyword argument of
    a checkpointable task body).

    Contract — steps run exactly once across preempt/migrate/restart:

        start = 0
        got = ckpt.restore()
        if got is not None:
            start = got[0] + 1          # the saved step is complete
        for step in range(start, n_steps):
            state = do_step(step, state)
            ckpt.save(step, state)      # durable (and the preemption
                                        # boundary) from here

    ``save`` raising ``TaskPreempted`` is normal control flow: let it
    propagate — the agent catches it and requeues/migrates the task.
    """

    def __init__(self, store: CheckpointStore, key: str):
        self.store = store
        self.key = key
        self._preempt = threading.Event()
        # transport hook: a process-mode transport points this at a
        # "forward the preempt flag down the worker pipe" closure while
        # the body runs remotely, so request_preempt() reaches the child
        self._forward: Optional[callable] = None

    def restore(self) -> Optional[Tuple[int, Any]]:
        """(last_saved_step, state), or None on a fresh start."""
        return self.store.latest(self.key)

    def save(self, step: int, state: Any):
        """Persist ``step`` then honor any pending preemption request."""
        self.store.save(self.key, step, state)
        if self._preempt.is_set():
            raise TaskPreempted(self.key, step)

    def preempt_requested(self) -> bool:
        """Bodies with long gaps between saves may poll this and
        checkpoint early to yield sooner."""
        return self._preempt.is_set()

    def request_preempt(self):
        """Agent-side: ask the body to unwind at its next save.  When the
        body executes in a worker process, the attached transport hook
        forwards the flag over the control pipe; the flag is also set
        locally first, so a hook attached *after* this call still sees it
        (the transport re-forwards on attach)."""
        self._preempt.set()
        fwd = self._forward
        if fwd is not None:
            try:
                fwd()
            except Exception:  # noqa: BLE001 — a dying pipe must not
                pass           # break the requester; the driver thread
                               # surfaces WorkerDied on its own
