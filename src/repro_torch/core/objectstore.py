"""Per-pool object store — the data plane (docs/dataplane.md).

Results used to travel *by value*: every producer→consumer edge pickled
the full result through the AppFuture (and, in proc mode, through a
pipe), and the journal's serializability probe walked it again.  RP's
data-staging model and Colmena's Redis result queues both land on the
same fix: a task's result is published **once** into a shared store and
everything downstream moves a *handle* — an ``ObjectRef`` carrying the
size, a dtype/pytree summary, and the owning pilot.

Semantics (pilots are threads of one process, so "transfer" is exact
bookkeeping of the bytes a multi-host deployment would move):

* **same-pilot deref is zero-copy** — the consumer gets the producer's
  in-memory object, no serialization, no copy;
* **cross-pilot deref fetches once** — the first deref from a foreign
  pilot counts ``ref.size`` toward ``bytes_moved`` and caches the object
  on that pilot, so N consumers on one pilot pay one transfer;
* **ref-counting rides the DFK dep graph** — the dep manager registers
  one consumer per edge at launch and releases it when the consumer's
  future completes; an object whose every registered consumer edge has
  completed is GC-eligible: it is spilled to disk (if not already
  durable) and its memory dropped.  A later deref re-materializes from
  the spill.  Objects with no registered consumers (a workflow's final
  results) stay live until ``close()``;
* **spill is content-addressed** — payloads land next to the journal in
  ``<journal>.obj/`` as ``blob_<sha1>.pkl`` plus a tiny ``<oid>.ref``
  pointer, written tmp+fsync+rename (the checkpoint durability idiom).
  Checkpoint leaves stored through ``put_blob`` share the same blob
  namespace, so a checkpointed state leaf that equals a published result
  costs one file, not two;
* **lost pilots re-host** — ``rehost`` moves a dead pilot's live objects
  to a survivor (memory hand-over in-process; the spill covers a
  restart), so resilience recovery never dangles refs.

The journal path cooperates (store.py): a DONE record whose result is an
``ObjectRef`` journals the ref *metadata* (oid, size, kind) and the
write-behind writer ensures the payload is spilled before the line
lands — durable-before-event, and exactly one serialization pass where
the old path walked a large result two or three times.
"""
from __future__ import annotations

import hashlib
import itertools
import os
import pickle
import sys
import tempfile
import threading
from typing import Any, Dict, Iterator, Optional, Set, Tuple

from . import serializer

DEFAULT_THRESHOLD = 64 * 1024       # publish results at/above this size

_oid_counter = itertools.count()


def _new_oid() -> str:
    return f"obj.{os.getpid()}.{next(_oid_counter):06d}"


# ----------------------------- size estimate ----------------------------- #
def estimate_size(value: Any, _depth: int = 0) -> int:
    """Cheap recursive byte estimate of a pytree-ish value: array leaves
    by ``nbytes``, bytes/str by length, containers by sum — never a
    serialization pass.  Non-leaf objects without a size signal count a
    token 32 bytes (small enough to stay inline)."""
    nb = getattr(value, "nbytes", None)
    if nb is not None:
        try:
            return int(nb)
        except (TypeError, ValueError):
            pass
    if isinstance(value, (bytes, bytearray, memoryview)):
        return len(value)
    if isinstance(value, str):
        return len(value)
    if _depth < 4:
        if isinstance(value, dict):
            return sum(estimate_size(v, _depth + 1)
                       for v in value.values()) + 64
        if isinstance(value, (list, tuple, set, frozenset)):
            return sum(estimate_size(v, _depth + 1) for v in value) + 64
    return 32


def _kind_summary(value: Any) -> str:
    """Human/journal-facing summary: dtype+shape for array leaves, type
    name otherwise."""
    dtype = getattr(value, "dtype", None)
    shape = getattr(value, "shape", None)
    if dtype is not None and shape is not None:
        return f"ndarray[{dtype}]{tuple(shape)}"
    return type(value).__name__


def _freeze(value: Any):
    """Mark a published ndarray read-only.  Published values are shared
    by reference: every same-pilot consumer derefs the same object, and
    proc-transport workers map one shared-memory mirror of it — a mutation
    anywhere would corrupt every other reader.  Freezing turns that
    silent race into an immediate ``ValueError`` (consumers that want to
    mutate copy first), and is what makes the transport's park-once
    segment cache safe.  Non-array values are left alone — the same
    contract holds, just unenforced."""
    flags = getattr(value, "flags", None)
    if flags is not None and getattr(flags, "writeable", False):
        try:
            value.flags.writeable = False
        except (AttributeError, ValueError):
            pass                        # views of foreign buffers etc.


def _tensor_version(value: Any) -> Optional[int]:
    """The in-place version counter of a published tensor, None for any
    other value.  A tensor has no read-only flag, so the store guards it
    by this counter instead: every in-place write bumps it, and a deref
    that finds it moved raises (``ObjectStore.get``) — the same silent
    race ``_freeze`` turns into an error for an ndarray, caught at the
    next read instead of at the write."""
    th = sys.modules.get("torch")
    if th is not None and isinstance(value, th.Tensor):
        return value._version
    return None


def _check_unmodified(oid: str, value: Any, version: Optional[int]):
    if version is not None and value._version != version:
        raise ValueError(
            f"published tensor {oid} was modified in place after it was "
            "published; consumers share it by reference and must copy "
            "before they mutate")


# -------------------------------- ObjectRef ------------------------------ #
class ObjectRef:
    """Handle to a published value: everything placement and the journal
    need (size, kind, owning pilot) without the payload.  The in-process
    backpointer to the store is dropped on pickle — a ref that crossed a
    process boundary resolves only through a store sharing the spill
    directory."""

    __slots__ = ("oid", "size", "kind", "pilot_uid", "_store")

    def __init__(self, oid: str, size: int, kind: str,
                 pilot_uid: Optional[str], store: "Optional[ObjectStore]"):
        self.oid = oid
        self.size = size
        self.kind = kind
        self.pilot_uid = pilot_uid
        self._store = store

    def deref(self, pilot_uid: Optional[str] = None) -> Any:
        if self._store is None:
            raise RuntimeError(
                f"ObjectRef {self.oid} has no live store (crossed a "
                f"process boundary without a shared spill dir)")
        return self._store.get(self, pilot_uid=pilot_uid)

    def __getstate__(self):
        return (self.oid, self.size, self.kind, self.pilot_uid)

    def __setstate__(self, state):
        self.oid, self.size, self.kind, self.pilot_uid = state
        self._store = None

    def __repr__(self):
        return (f"<ObjectRef {self.oid} {self.kind} {self.size}B "
                f"@{self.pilot_uid}>")


class _Entry:
    __slots__ = ("value", "size", "kind", "owner", "consumers",
                 "registered", "sha", "cached_on", "dropped", "version")

    def __init__(self, value, size, kind, owner):
        self.value = value
        self.version = _tensor_version(value)   # in-place write guard
        self.size = size
        self.kind = kind
        self.owner = owner          # pilot uid holding the primary copy
        self.consumers = 0          # outstanding DFK consumer edges
        self.registered = 0         # total edges ever registered
        self.sha: Optional[str] = None   # set once spilled (blob id)
        self.cached_on: Set[str] = set()  # pilots holding a fetched copy
        self.dropped = False        # memory copy GC'd (spill is truth)


# ------------------------------- ObjectStore ----------------------------- #
class ObjectStore:
    """One per PilotPool.  Thread-safe; all counters under one lock —
    publish/deref are rare relative to scheduling events, and deref's
    fast path (same-pilot, in memory) does no copying under the lock."""

    def __init__(self, spill_dir: Optional[str] = None,
                 threshold: int = DEFAULT_THRESHOLD):
        self.threshold = threshold
        self._lock = threading.Lock()
        self._objects: Dict[str, _Entry] = {}
        self._blobs: Set[str] = set()       # shas known to be on disk
        self._spill_dir = spill_dir
        self._tmpdir: Optional[tempfile.TemporaryDirectory] = None
        self._closed = False
        # stats — exp6/exp11 and the docs' observability contract
        self.published = 0
        self.bytes_published = 0
        self.bytes_moved = 0        # cross-pilot fetches, counted once
                                    # per (object, consumer pilot)
        self.spills = 0
        self.rehosted = 0

    # ------------------------------ publish ----------------------------- #
    def maybe_publish(self, value: Any, owner: Optional[str]) -> Any:
        """Publish ``value`` when its estimated size reaches the
        threshold, else return it unchanged (small results stay inline —
        ``AppFuture.quick_result`` remains lock-free for them)."""
        if value is None or isinstance(value, ObjectRef):
            return value
        size = estimate_size(value)
        if size < self.threshold:
            return value
        return self.publish(value, owner, size=size)

    def publish(self, value: Any, owner: Optional[str],
                size: Optional[int] = None) -> ObjectRef:
        size = estimate_size(value) if size is None else size
        _freeze(value)
        oid = _new_oid()
        with self._lock:
            self._objects[oid] = _Entry(value, size, _kind_summary(value),
                                        owner)
            self.published += 1
            self.bytes_published += size
        return ObjectRef(oid, size, _kind_summary(value), owner, self)

    # -------------------------------- deref ----------------------------- #
    def get(self, ref, pilot_uid: Optional[str] = None) -> Any:
        """Dereference.  ``pilot_uid`` names the consuming pilot for byte
        accounting; ``None`` is a client-side read (uncounted).  Unknown
        oids fall back to the spill directory — the replay/restart path."""
        oid = ref.oid if isinstance(ref, ObjectRef) else ref
        hit = None
        with self._lock:
            e = self._objects.get(oid)
            if e is not None and not e.dropped:
                hit = (e.value, e.version)
                self._account(e, pilot_uid)
        if hit is not None:
            _check_unmodified(oid, *hit)
            return hit[0]
        # cold: re-materialize from spill (outside the lock — disk read)
        value = self._load_spilled(oid)
        with self._lock:
            e = self._objects.get(oid)
            if e is None:
                e = _Entry(value, estimate_size(value),
                           _kind_summary(value), None)
                self._objects[oid] = e
            elif e.dropped:
                e.value = value
                e.version = _tensor_version(value)
                e.dropped = False
            self._account(e, pilot_uid)
            return e.value

    def _account(self, e: _Entry, pilot_uid: Optional[str]):
        """Caller holds the lock: count a cross-pilot fetch once per
        (object, pilot)."""
        if (pilot_uid is not None and pilot_uid != e.owner
                and pilot_uid not in e.cached_on):
            e.cached_on.add(pilot_uid)
            self.bytes_moved += e.size

    # ------------------------------ refcount ----------------------------- #
    def add_consumers(self, oid: str, n: int = 1):
        """DFK dep manager: ``n`` more consumer edges will read this
        object.  Unknown oids (replayed workflows) are ignored."""
        with self._lock:
            e = self._objects.get(oid)
            if e is not None:
                e.consumers += n
                e.registered += n

    def release(self, oid: str):
        """One consumer edge completed.  At zero outstanding edges the
        object is GC'd: spilled (if not yet durable) and dropped from
        memory.  Releases past zero are ignored — the exactly-once
        contract is enforced here, not trusted from callers."""
        gc_entry = None
        with self._lock:
            e = self._objects.get(oid)
            if e is None or e.consumers <= 0:
                return
            e.consumers -= 1
            if e.consumers == 0 and not e.dropped:
                gc_entry = e
        if gc_entry is not None:
            self._gc(oid, gc_entry)

    def _gc(self, oid: str, e: _Entry):
        if self._closed:
            return                  # teardown: consumers are gone too
        try:
            self.ensure_spilled(oid)
        except serializer.SerializationError:
            return                  # unspillable: keep the memory copy
        except OSError:
            return                  # spill dir tearing down concurrently:
                                    # keep the memory copy, close() wins
        with self._lock:
            if e.consumers == 0:    # no new edge registered meanwhile
                e.value = None
                e.dropped = True
                e.cached_on.clear()

    # -------------------------------- spill ------------------------------ #
    @property
    def spill_dir(self) -> str:
        if self._spill_dir is None:
            self._tmpdir = tempfile.TemporaryDirectory(prefix="repro-obj-")
            self._spill_dir = self._tmpdir.name
        os.makedirs(self._spill_dir, exist_ok=True)
        return self._spill_dir

    def _blob_path(self, sha: str) -> str:
        return os.path.join(self.spill_dir, f"blob_{sha}.pkl")

    def _ref_path(self, oid: str) -> str:
        return os.path.join(self.spill_dir, f"{oid}.ref")

    def _write_atomic(self, path: str, data: bytes):
        d = os.path.dirname(path)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(data)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def put_blob(self, value: Any) -> Tuple[str, int]:
        """Content-addressed persist: ``(sha, size)``.  A blob already on
        disk is not rewritten — this is the dedupe point shared by result
        spills and checkpoint pytree leaves.  Frozen arrays are pickled
        from a writable copy: ndarray pickles encode flag state, and the
        publish-time freeze must not make a spilled result hash
        differently from the byte-identical checkpoint leaf."""
        flags = getattr(value, "flags", None)
        if flags is not None and not getattr(flags, "writeable", True):
            try:
                value = value.copy()
            except (AttributeError, TypeError):
                pass
        blob = serializer.dumps(value)
        sha = hashlib.sha1(blob).hexdigest()
        with self._lock:
            known = sha in self._blobs
        if not known:
            path = self._blob_path(sha)
            if not os.path.exists(path):
                self._write_atomic(path, blob)
                with self._lock:
                    self.spills += 1
            with self._lock:
                self._blobs.add(sha)
        return sha, len(blob)

    def get_blob(self, sha: str) -> Any:
        with open(self._blob_path(sha), "rb") as fh:
            return pickle.load(fh)

    def ensure_spilled(self, oid: str) -> Optional[str]:
        """Make ``oid`` durable (idempotent): payload blob + ``.ref``
        pointer on disk before returning.  The journal writer calls this
        before the DONE line lands.  Returns the blob sha (None for
        unknown oids).  Raises SerializationError for unspillable
        values."""
        with self._lock:
            e = self._objects.get(oid)
            if e is None or e.sha is not None:
                return e.sha if e is not None else None
            value = e.value
        sha, _ = self.put_blob(value)
        self._write_atomic(self._ref_path(oid), sha.encode("ascii"))
        with self._lock:
            e.sha = sha
        return sha

    def _load_spilled(self, oid: str) -> Any:
        ref_path = self._ref_path(oid)
        try:
            with open(ref_path, "rb") as fh:
                sha = fh.read().decode("ascii").strip()
        except OSError:
            raise KeyError(f"object {oid} is not in the store and has "
                           f"no spill under {self._spill_dir}") from None
        value = self.get_blob(sha)
        _freeze(value)                  # reloads are published values too
        return value

    def has_spilled(self, oid: str) -> bool:
        with self._lock:
            e = self._objects.get(oid)
            if e is not None and e.sha is not None:
                return True
        return (self._spill_dir is not None
                and os.path.exists(self._ref_path(oid)))

    # ------------------------------- rehost ------------------------------ #
    def rehost(self, lost_uid: str, survivor_uid: Optional[str]) -> int:
        """A pilot died or retired: move ownership of its live objects to
        ``survivor_uid`` so existing refs keep resolving without a
        cross-pilot charge against a dead owner.  In-process the value is
        already reachable (hand-over, not copy); a dropped value stays
        loadable from its spill.  Returns the number re-homed."""
        n = 0
        with self._lock:
            for e in self._objects.values():
                if e.owner == lost_uid:
                    e.owner = survivor_uid
                    e.cached_on.discard(survivor_uid)
                    n += 1
            self.rehosted += n
        return n

    # ------------------------------- helpers ----------------------------- #
    def live_count(self) -> int:
        with self._lock:
            return sum(1 for e in self._objects.values() if not e.dropped)

    def entry(self, oid: str) -> Optional[_Entry]:
        """Test/introspection access to the raw entry."""
        with self._lock:
            return self._objects.get(oid)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "published": self.published,
                "bytes_published": self.bytes_published,
                "bytes_moved": self.bytes_moved,
                "spills": self.spills,
                "rehosted": self.rehosted,
                "live": sum(1 for e in self._objects.values()
                            if not e.dropped),
            }

    def close(self):
        self._closed = True         # late releases become no-op GCs
        with self._lock:
            self._objects.clear()
            self._blobs.clear()
        if self._tmpdir is not None:
            self._tmpdir.cleanup()
            self._tmpdir = None
            self._spill_dir = None


class BlobLeaf:
    """Content-addressed placeholder for a large pytree leaf persisted
    through ``ObjectStore.put_blob`` — the checkpoint store writes these
    into its pickled skeletons so a state leaf that equals a published
    result (or a leaf shared by many steps) costs one blob on disk, not
    one copy per checkpoint.  Rehydrates with ``get_blob``."""

    __slots__ = ("sha", "size", "kind")

    def __init__(self, sha: str, size: int, kind: str):
        self.sha, self.size, self.kind = sha, size, kind

    def __getstate__(self):
        return (self.sha, self.size, self.kind)

    def __setstate__(self, state):
        self.sha, self.size, self.kind = state

    def __repr__(self):
        return f"<BlobLeaf {self.sha[:12]} {self.kind} {self.size}B>"


# ------------------------- ref plumbing helpers -------------------------- #
def iter_refs(obj: Any, _depth: int = 0) -> Iterator[ObjectRef]:
    """Yield every ObjectRef in a (shallow) args/kwargs structure."""
    if isinstance(obj, ObjectRef):
        yield obj
        return
    if _depth >= 3:
        return
    if isinstance(obj, dict):
        for v in obj.values():
            yield from iter_refs(v, _depth + 1)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from iter_refs(v, _depth + 1)


def materialize(obj: Any, store: Optional[ObjectStore],
                pilot_uid: Optional[str] = None, _depth: int = 0) -> Any:
    """Replace every ObjectRef in args/kwargs with its value, charging
    cross-pilot bytes to ``pilot_uid`` — called on the *executing* pilot,
    so byte attribution survives stealing, retries, and migration."""
    if isinstance(obj, ObjectRef):
        s = obj._store or store
        if s is None:
            raise RuntimeError(f"cannot materialize {obj!r}: no store")
        return s.get(obj, pilot_uid=pilot_uid)
    if _depth >= 3:
        return obj
    if isinstance(obj, dict):
        out = {k: materialize(v, store, pilot_uid, _depth + 1)
               for k, v in obj.items()}
        return out if any(o is not n for o, n in
                          zip(obj.values(), out.values())) else obj
    if isinstance(obj, (list, tuple)):
        out = [materialize(v, store, pilot_uid, _depth + 1) for v in obj]
        if all(o is n for o, n in zip(obj, out)):
            return obj
        if isinstance(obj, list):
            return out
        if hasattr(obj, "_fields"):         # NamedTuple
            return type(obj)(*out)
        return tuple(out)
    return obj
