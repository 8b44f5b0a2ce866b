"""WorkerTransport — pluggable agent→worker call path.

The Agent schedules; a *transport* executes.  This is the paper's
master/worker split (RP's MPI executor: the agent process schedules, OS
processes run task bodies) extracted behind one seam so a Pilot can own
either of:

  * ``InprocTransport`` (default) — the original persistent thread pool.
    Task bodies run in the agent's process; byte-for-byte the pre-split
    behavior, and the only mode for spmd tasks (a sub-mesh is bound to
    this process's devices and CUDA context).

  * ``ProcessTransport`` — a lazily-grown pool of OS worker processes,
    one duplex pipe each.  Python/bash task bodies execute *off the GIL*:
    the local pool thread that drives a task blocks in ``Connection.recv``
    (GIL released) while the child burns a core, so bulk CPU-bound
    throughput scales with cores instead of serializing behind the
    interpreter lock (the exp3 ceiling ROADMAP item 3 calls out).

Both transports share the local thread-pool machinery (``_PoolBase``):
the agent's bookkeeping — state transitions, finish paths, replica and
preempt logic — always runs in these local threads, so every Agent
invariant holds identically in both modes; only the body call in
``execute()`` differs.  The pool is bounded *and reaped*: a thread idle
longer than ``idle_s`` with no undispatched work retires itself, so a
64-task burst does not leave 64 live threads at steady state.

Process-mode protocol (FIFO pipe, one in-flight run per worker, per-run
``seq`` so a stale message from a previous run can never poison the
next task on a reused worker):

  parent → child:  ("run", seq, payload, checkpointable, key, snapshot,
                    shm_threshold)
                   ("preempt", seq)            cooperative preempt flag
                   ("save_ack", seq, preempt)  checkpoint persisted
                   ("stop",)
  child → parent:  ("save", seq, step, blob)   body called ckpt.save
                   ("done", seq, blob)         result crossed back
                   ("done_shm", seq, meta)     large ndarray result in a
                                               shared-memory segment
                   ("done_raw", seq, info)     result could not cross
                   ("preempted", seq, step)    body unwound at a save
                   ("error", seq, blob)        packed remote exception

Shared-memory fast path (docs/dataplane.md): with ``shm_threshold`` set,
large C-contiguous ndarray *arguments* are parked in shared-memory
segments parent-side and cross the pipe as small ``_ShmLeaf`` markers
the child maps read-only — one memcpy instead of pickle-serialize +
chunked pipe writes + deserialize. A contiguous CPU tensor without
autograd history takes the same path through its ``.numpy()`` view and
arrives as a tensor over the segment, mapped copy-on-write (a tensor has
no read-only flag: a body's in-place write lands in private pages, never
in the parent's buffer); dtypes numpy lacks (bfloat16) pickle. Frozen
arrays (published by the object store, which freezes on publish) are
parked *once per object* in ``_SegCache`` and the one segment serves
every consumer; mutable arrays park one-shot per run. Large ndarray
*results* come back the same way: the child writes the array into a
segment named ``{prefix}r{pid}_{seq}`` and ships only the metadata.
Ownership is strict so nothing leaks: the parent unlinks one-shot
argument segments when the run reaches a terminal state (the child is
done reading by then), cached segments when their array dies (weakref)
or at shutdown, and result segments after copying out — or, when a
worker dies mid-run (SIGKILL, OOM), via ``_discard``'s reap of
``/dev/shm/{prefix}r{pid}_*``. Workers use raw ``shm_open`` + ``mmap``
(``_RawSeg``) on both sides of their boundary: the stdlib wrapper
registers every attach/create with a ``resource_tracker``, and a forked
child that first touches shm post-fork starts its *own* tracker, which
then warns at worker exit about segments the parent rightly unlinked —
so children simply never register anything.

Checkpoint proxying keeps the inproc persist-then-raise contract across
the boundary: the child's ``ckpt.save`` *blocks* until the parent has
persisted the step through the pilot's CheckpointStore and acked with
the current preempt flag — only then does the body continue (or unwind
with ``TaskPreempted``), so a handed-off task always has its last step
durable parent-side.  ``restore`` is a snapshot shipped with the run
request (the latest parent-side checkpoint).  Preempt requests travel
``Checkpoint._forward`` → pipe → the child's flag, honored at its next
``save``/``preempt_requested`` poll — exactly the inproc cadence.

Worker death (crash, OOM-kill, fault injection) surfaces as an EOF on
the pipe: the in-flight task FAILs visibly with ``WorkerDied`` (feeding
the agent's normal retry/replica paths), the slot is released by the
usual finish path, the corpse is discarded, and the pool lazily
respawns on the next checkout.  spmd tasks (``TaskRecord.inproc_only``,
stamped by the translator) and bodies the serializer cannot ship fall
back to in-process execution rather than failing the task.
"""
from __future__ import annotations

import glob
import itertools
import mmap
import multiprocessing
import os
import queue
import sys
import threading
import warnings
import weakref
from typing import Callable, Optional

try:                                     # CPython's posix shm primitive —
    import _posixshmem                   # lets the forked child map
except ImportError:                      # segments without the stdlib
    _posixshmem = None                   # wrapper's resource tracker

from . import serializer
from .checkpoint import TaskPreempted

try:
    import numpy as _np
except ImportError:                      # pragma: no cover - numpy is a
    _np = None                           # hard dep everywhere else

_SENTINEL = object()

# --------------------------- shared memory -------------------------------- #
_SHM_PREFIX = "rpxshm"                   # /dev/shm/rpxshm* is ours to reap
_shm_counter = itertools.count()


class _ShmLeaf:
    """Pipe-crossing marker for an ndarray parked in a shared-memory
    segment: (segment name, shape, dtype str, whether it was a tensor).
    Pickles tiny."""

    __slots__ = ("name", "shape", "dtype", "tensor")

    def __init__(self, name, shape, dtype, tensor=False):
        self.name, self.shape, self.dtype = name, shape, dtype
        self.tensor = tensor

    def __getstate__(self):
        return (self.name, self.shape, self.dtype, self.tensor)

    def __setstate__(self, s):
        self.name, self.shape, self.dtype, self.tensor = s


def _shm_view(v, threshold: int):
    """The ndarray that crosses by shared memory for ``v``: ``v`` itself
    for a large C-contiguous ndarray, the ``.numpy()`` view of a large
    contiguous CPU tensor without autograd history; None when ``v`` takes
    the pickle path."""
    if _np is None:
        return None
    arr = v
    if not isinstance(v, _np.ndarray):
        th = sys.modules.get("torch")
        if (th is None or not isinstance(v, th.Tensor)
                or v.device.type != "cpu" or v.requires_grad
                or not v.is_contiguous()):
            return None
        try:
            arr = v.numpy()
        except (TypeError, RuntimeError):   # no numpy dtype (bfloat16)
            return None
    if (arr.dtype.hasobject or arr.nbytes < threshold
            or not arr.flags.c_contiguous):
        return None
    return arr


def _as_tensor(arr):
    """A tensor over ``arr``'s buffer (no copy)."""
    import torch
    return torch.from_numpy(arr)


def _shm_attach(name: str):
    """Attach an existing segment.  Attach *registers* with the resource
    tracker on 3.8–3.12 (bpo-39959), but every worker is a child of the
    pilot process and children inherit the parent's tracker, so the
    registration lands in the same per-name set the creator's did — a
    no-op — and the eventual ``unlink`` unregisters it exactly once."""
    from multiprocessing import shared_memory
    return shared_memory.SharedMemory(name=name)


def _shm_park(arr, name: Optional[str] = None, tensor: bool = False):
    """Copy an ndarray into a fresh segment; returns (leaf, segment)."""
    from multiprocessing import shared_memory
    if name is None:
        name = f"{_SHM_PREFIX}a{os.getpid()}_{next(_shm_counter)}"
    seg = shared_memory.SharedMemory(create=True, size=arr.nbytes, name=name)
    _np.ndarray(arr.shape, dtype=arr.dtype, buffer=seg.buf)[...] = arr
    return _ShmLeaf(seg.name, arr.shape, str(arr.dtype), tensor), seg


class _RawSeg:
    """Child-side segment handle: raw ``shm_open`` + ``mmap``, no
    ``multiprocessing.shared_memory``.  A forked worker that first
    touches shm *after* the fork would otherwise start its own resource
    tracker, which then warns at worker exit about every segment the
    parent (rightly) unlinked.  Children therefore never register
    anything; the parent remains the sole tracker client."""

    __slots__ = ("name", "mm")

    def __init__(self, name, mm):
        self.name, self.mm = name, mm

    @property
    def buf(self):
        return self.mm

    def close(self):
        try:
            self.mm.close()
        except (BufferError, OSError):
            pass                        # a live view pins the map; the
                                        # array's GC drops it

    def unlink(self):
        _posixshmem.shm_unlink("/" + self.name)


def _shm_attach_child(name: str, private: bool = False):
    """Read-only attach from a worker process, tracker-free; ``private``
    maps it copy-on-write instead (writes stay in this process)."""
    if _posixshmem is None:             # pragma: no cover - linux has it
        return _shm_attach(name)
    fd = _posixshmem.shm_open("/" + name, os.O_RDONLY, mode=0)
    try:
        size = os.fstat(fd).st_size
        mm = (mmap.mmap(fd, size, access=mmap.ACCESS_COPY) if private
              else mmap.mmap(fd, size, prot=mmap.PROT_READ))
    finally:
        os.close(fd)
    return _RawSeg(name, mm)


def _shm_park_child(arr, name: str, tensor: bool = False):
    """Create + fill a segment from a worker process, tracker-free; the
    parent owns the unlink (or ``_shm_reap`` does, if we die first)."""
    if _posixshmem is None:             # pragma: no cover - linux has it
        return _shm_park(arr, name=name, tensor=tensor)
    fd = _posixshmem.shm_open("/" + name,
                              os.O_RDWR | os.O_CREAT | os.O_EXCL,
                              mode=0o600)
    try:
        os.ftruncate(fd, arr.nbytes)
        mm = mmap.mmap(fd, arr.nbytes)
    finally:
        os.close(fd)
    _np.ndarray(arr.shape, dtype=arr.dtype, buffer=mm)[...] = arr
    leaf = _ShmLeaf(name, arr.shape, str(arr.dtype), tensor)
    return leaf, _RawSeg(name, mm)


class _SegCache:
    """Park-once reuse for *frozen* argument arrays.

    The object store freezes every ndarray it publishes
    (``writeable=False``) and same-pilot ``materialize`` hands each
    consumer the very same object, so a fan-out of N proc-mode consumers
    would otherwise pay N identical park copies (a 4 MB park is ~6 ms of
    zero-fill page faults — costlier than the pickle it replaces).  Keyed
    on ``id()`` with a weakref guard: when the array dies (object-store
    GC dropping the value), the callback unlinks the segment.  Mutable
    arrays never enter the cache — they take the one-shot park path."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict = {}        # id(arr) -> (leaf, seg, wref)

    def park(self, arr) -> _ShmLeaf:
        key = id(arr)
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None and hit[2]() is arr:
                return hit[0]
            leaf, seg = _shm_park(arr)

            def _evict(_wr, seg=seg):
                _shm_release([seg])     # no lock: may fire mid-GC on any
                                        # thread; the dict slot is swept
                                        # lazily below
            self._entries[key] = (leaf, seg, weakref.ref(arr, _evict))
            if len(self._entries) > 64:
                for k, (_, _, wr) in list(self._entries.items()):
                    if wr() is None:
                        self._entries.pop(k, None)
            return leaf

    def close(self):
        with self._lock:
            entries, self._entries = self._entries, {}
        for _, seg, wr in entries.values():
            if wr() is not None:        # dead entries already unlinked
                _shm_release([seg])     # by their weakref callback


def _shm_substitute(args: tuple, kwargs: dict, threshold: int,
                    cache: Optional[_SegCache] = None):
    """Replace top-level large ndarray (or CPU tensor) args/kwarg values
    with _ShmLeaf markers.  Returns (args, kwargs, created segments) — the
    caller owns the one-shot segments and unlinks them once the run is
    terminal; cache-parked segments (frozen arrays) are owned by the
    cache.  Tensors park one-shot: nothing marks them frozen."""
    segs = []

    def swap(v):
        arr = _shm_view(v, threshold)
        if arr is not None:
            if arr is v and cache is not None and not v.flags.writeable:
                return cache.park(v)
            leaf, seg = _shm_park(arr, tensor=arr is not v)
            segs.append(seg)
            return leaf
        return v

    new_args = tuple(swap(v) for v in args)
    new_kwargs = {k: swap(v) for k, v in kwargs.items()}
    return new_args, new_kwargs, segs


def _shm_release(segs):
    for seg in segs:
        try:
            seg.close()
            seg.unlink()
        except (FileNotFoundError, OSError):
            pass


class WorkerDied(RuntimeError):
    """A process-mode worker died while (or before) running a task; the
    task FAILs through the agent's normal fault path and may retry."""


class _PoolBase:
    """Local persistent thread pool (the MPI-Worker analog) shared by
    both transports: lazy growth to ``max_workers``, bounded idle (a
    worker idle > ``idle_s`` with nothing undispatched reaps itself),
    and dropped handles for exited threads."""

    def __init__(self, max_workers: int = 32, idle_s: float = 30.0):
        self.max_workers = max_workers
        self.idle_s = idle_s
        self.executor = None            # set by start()
        self._run_cb: Optional[Callable] = None
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._threads: set = set()
        self._ready = 0                 # dispatched, not yet claimed
        self._executing = 0             # claimed, still running
        self._closed = False            # set by shutdown(); later dispatch
                                        # raises instead of stranding the
                                        # task behind a leftover poison pill

    # ------------------------------ protocol ----------------------------- #
    def start(self, run_cb: Callable, executor) -> "_PoolBase":
        """Bind the agent's per-task runner and its (inproc) executor.
        Threads stay lazy; nothing spawns until the first dispatch."""
        self._run_cb = run_cb
        self.executor = executor
        return self

    def dispatch(self, task):
        """Hand a scheduled task to the pool.  Grows until the thread set
        covers all claimed work (executing + undispatched), so tasks
        scheduled in one pass run concurrently."""
        with self._lock:
            if self._closed:
                # a post-shutdown dispatch would race the poison pills: a
                # freshly-spawned thread can consume a leftover sentinel
                # and retire, stranding the task in the queue forever
                raise RuntimeError("transport pool is shut down")
            self._ready += 1
            want = self._executing + self._ready
            if len(self._threads) < min(self.max_workers, want):
                th = threading.Thread(target=self._worker_loop, daemon=True)
                self._threads.add(th)
                th.start()
        self._q.put(task)

    def execute(self, task):
        raise NotImplementedError

    def shutdown(self):
        with self._lock:
            self._closed = True         # reject future dispatches before
            n = len(self._threads)      # any pill can hit the queue
        for _ in range(n):              # one poison pill per live thread;
            self._q.put(_SENTINEL)      # a racing self-reap leaves a spare
                                        # pill in the queue, harmlessly

    @property
    def n_threads(self) -> int:
        """Live pool threads (the hygiene-regression observable)."""
        with self._lock:
            return len(self._threads)

    @property
    def n_idle(self) -> int:
        with self._lock:
            return len(self._threads) - self._executing

    # ------------------------------ internals ---------------------------- #
    def _worker_loop(self):
        me = threading.current_thread()
        while True:
            try:
                item = self._q.get(timeout=self.idle_s)
            except queue.Empty:
                with self._lock:
                    if self._ready == 0:
                        # idle past the bound with nothing undispatched:
                        # retire.  dispatch() increments _ready under
                        # this lock *before* the queue put, so a racing
                        # dispatch either sees us gone (and spawns a
                        # replacement) or we see its claim and keep
                        # waiting — a task is never stranded.
                        self._threads.discard(me)
                        return
                continue                # claimed work is in flight to the
                                        # queue — wait another round
            if item is _SENTINEL:
                with self._lock:
                    self._threads.discard(me)
                return
            with self._lock:
                self._ready -= 1
                self._executing += 1
            try:
                self._run_cb(item)
            finally:
                with self._lock:
                    self._executing -= 1


class InprocTransport(_PoolBase):
    """The original in-process pool: body runs on the pool thread via the
    agent's SPMDFunctionExecutor.  Default; behavior-compatible."""

    name = "inproc"

    def execute(self, task):
        return self.executor.execute(task)


class _ProcWorker:
    __slots__ = ("proc", "conn", "send_lock", "seq")

    def __init__(self, proc, conn):
        self.proc = proc
        self.conn = conn
        self.send_lock = threading.Lock()   # driver (save_ack) and the
        self.seq = 0                        # preempt forwarder both send


class ProcessTransport(_PoolBase):
    """Process pool: each local pool thread drives at most one worker
    process over a duplex pipe; the body executes in the child, off the
    GIL.  Workers spawn lazily up to ``max_workers``, are reused across
    tasks, and are discarded + lazily respawned on death."""

    name = "proc"

    def __init__(self, max_workers: int = 32, idle_s: float = 30.0,
                 start_method: Optional[str] = None,
                 shm_threshold: Optional[int] = None):
        super().__init__(max_workers, idle_s)
        self.shm_threshold = shm_threshold   # ndarray args/results at or
                                             # above this cross via shared
                                             # memory; None = pickle pipe
        # fork is the cheap default on linux (the child never touches the
        # parent's CUDA runtime, which a forked child cannot use: the
        # serializer moves tensors to the CPU before they cross); spawn is
        # the conservative opt-in
        self._mp = multiprocessing.get_context(start_method or "fork")
        self._seg_cache = _SegCache()   # park-once for frozen (published)
                                        # argument arrays
        self._pcond = threading.Condition()
        self._free: list = []           # idle workers (LIFO: warm reuse)
        self._all: set = set()          # every live worker (shutdown sweep)
        self._total = 0                 # live + being-spawned workers

    # ------------------------------ execution ---------------------------- #
    def execute(self, task):
        if task.inproc_only or task.kind == "spmd":
            # a sub-mesh is bound to the parent's CUDA context — spmd
            # never crosses (the translator stamps inproc_only accordingly)
            return self.executor.execute(task)
        kwargs = dict(task.kwargs)
        kwargs.pop("_jit", None)        # spmd-only knob; meaningless here
        kwargs.pop("ckpt", None)        # the child injects its own proxy
        args = task.args
        segs = []
        if self.shm_threshold is not None:
            # park large ndarray inputs in shared memory: the child
            # re-attaches read-only, so only tiny markers cross the pipe
            args, kwargs, segs = _shm_substitute(args, kwargs,
                                                 self.shm_threshold,
                                                 cache=self._seg_cache)
        try:
            try:
                payload = serializer.pack_task(task.fn, args, kwargs)
            except serializer.SerializationError:
                # body cannot ship — degrade to in-process execution
                # instead of failing the task (same spirit as the
                # result-side degradation: correctness first,
                # parallelism best-effort)
                return self.executor.execute(task)
            w = self._checkout()
            try:
                result = self._drive(w, task, payload)
            except WorkerDied:
                self._discard(w)
                raise                   # agent's fault path: FAIL + retry
            except BaseException:       # noqa: BLE001 — remote error or
                self._checkin(w)        # TaskPreempted: worker is healthy
                raise
            self._checkin(w)
            return result
        finally:
            # the run is terminal (or never started): the child is done
            # reading, so the argument segments can go.  Parent-side
            # unlink is what makes arg segments leak-proof no matter how
            # the child dies.
            _shm_release(segs)

    def _drive(self, w: _ProcWorker, task, payload: bytes):
        """Run one task on one worker: send the run request, then pump
        the pipe until a terminal message.  Raises WorkerDied on EOF."""
        w.seq += 1
        seq = w.seq
        ctx = task.ckpt_ctx
        key = task.ckpt_key or task.uid
        snapshot = None
        if ctx is not None:
            got = ctx.restore()         # parent-side latest checkpoint
            if got is not None:
                try:
                    snapshot = (got[0], serializer.dumps(got[1]))
                except serializer.SerializationError:
                    snapshot = None     # unshippable state: fresh start
        self._send(w, ("run", seq, payload, ctx is not None, key, snapshot,
                       self.shm_threshold))
        if ctx is not None:
            def _fwd():
                try:
                    self._send(w, ("preempt", seq))
                except WorkerDied:
                    pass                # the recv loop will surface it
            ctx._forward = _fwd
            if ctx.preempt_requested():
                _fwd()                  # request landed before the hook —
                                        # re-send now that the run is out
        try:
            while True:
                try:
                    msg = w.conn.recv()
                except (EOFError, OSError) as e:
                    raise WorkerDied(
                        f"worker pid {w.proc.pid} died while running "
                        f"{task.uid}") from e
                if msg[1] != seq:
                    continue            # stale leftover from a prior run
                tag = msg[0]
                if tag == "save":
                    _, _, step, blob = msg
                    if ctx is not None and blob is not None:
                        # persist through the pilot's CheckpointStore
                        # BEFORE acking: the child's save() blocks until
                        # the step is durable here (persist-then-raise,
                        # same as inproc).  blob=None means the state
                        # could not cross — ack anyway, the body keeps
                        # running with a non-durable step (the store's
                        # own memory-only fallback has the same shape).
                        ctx.store.save(key, step, serializer.loads(blob))
                    pre = ctx is not None and ctx.preempt_requested()
                    self._send(w, ("save_ack", seq, pre))
                elif tag == "done":
                    return serializer.loads(msg[2])
                elif tag == "done_shm":
                    name, shape, dtype, tensor = msg[2]
                    seg = _shm_attach(name)
                    try:
                        out = _np.ndarray(shape, dtype=dtype,
                                          buffer=seg.buf).copy()
                    finally:
                        _shm_release([seg])
                    return _as_tensor(out) if tensor else out
                elif tag == "done_raw":
                    return serializer.UnserializableResult(*msg[2])
                elif tag == "preempted":
                    raise TaskPreempted(key, msg[2])
                elif tag == "error":
                    raise serializer.unpack_exception(msg[2])
        finally:
            if ctx is not None:
                ctx._forward = None
    # ----------------------------- worker pool --------------------------- #
    def _send(self, w: _ProcWorker, msg):
        try:
            with w.send_lock:
                w.conn.send(msg)
        except (OSError, ValueError, BrokenPipeError) as e:
            raise WorkerDied(
                f"worker pid {w.proc.pid} pipe closed") from e

    def _checkout(self) -> _ProcWorker:
        with self._pcond:
            while True:
                while self._free:
                    w = self._free.pop()
                    if w.proc.is_alive():
                        return w
                    self._all.discard(w)    # died while idle: silent drop
                    self._total -= 1
                    self._close(w)
                if self._total < self.max_workers:
                    self._total += 1
                    break
                self._pcond.wait(1.0)       # a thread beyond max_workers
                                            # waits for a checkin (cannot
                                            # happen while threads share
                                            # the same bound, but cheap)
        try:
            w = self._spawn()
        except BaseException:
            with self._pcond:
                self._total -= 1
                self._pcond.notify()
            raise
        with self._pcond:
            self._all.add(w)
        return w

    def _checkin(self, w: _ProcWorker):
        with self._pcond:
            self._free.append(w)
            self._pcond.notify()

    def _discard(self, w: _ProcWorker):
        """Drop a dead (or poisoned) worker; the pool respawns lazily on
        the next checkout."""
        with self._pcond:
            self._all.discard(w)
            self._total -= 1
            self._pcond.notify()
        self._close(w)
        self._shm_reap(w.proc.pid)

    @staticmethod
    def _shm_reap(pid: Optional[int]):
        """Unlink any result segments a dead worker left behind: a child
        SIGKILLed between creating ``{prefix}r{pid}_{seq}`` and the
        parent's copy-out is the only leak window, and the deterministic
        name closes it."""
        if pid is None or not os.path.isdir("/dev/shm"):
            return
        for path in glob.glob(f"/dev/shm/{_SHM_PREFIX}r{pid}_*"):
            try:
                # attach + unlink (not a bare os.unlink) so the shared
                # resource tracker's registration is retired with the
                # segment — no "leaked shared_memory" noise at exit
                _shm_release([_shm_attach(os.path.basename(path))])
            except OSError:
                pass

    def _spawn(self) -> _ProcWorker:
        parent, child = self._mp.Pipe(duplex=True)
        p = self._mp.Process(target=_proc_worker_main, args=(child,),
                             daemon=True)
        with warnings.catch_warnings():
            # os.fork() in a multithreaded parent warns; the child only
            # pumps the pipe and runs user bodies — it never calls into
            # the parent's CUDA runtime (tensors are moved to the CPU by
            # the serializer before crossing)
            warnings.simplefilter("ignore", RuntimeWarning)
            p.start()
        child.close()
        return _ProcWorker(p, parent)

    @staticmethod
    def _close(w: _ProcWorker):
        try:
            w.conn.close()
        except OSError:
            pass
        if w.proc.is_alive():
            w.proc.terminate()
        w.proc.join(timeout=1.0)

    @property
    def n_procs(self) -> int:
        with self._pcond:
            return self._total

    def worker_pids(self, busy_only: bool = False) -> list:
        """Pids of live worker processes — the chaos harness's worker-kill
        and task-hang schedules pick their victims here (its presence is
        also how the FaultInjector recognizes a proc-transport pilot).
        ``busy_only`` restricts to workers currently driving a task."""
        with self._pcond:
            live = [w for w in self._all if w.proc.is_alive()]
            if busy_only:
                idle = {id(w) for w in self._free}
                live = [w for w in live if id(w) not in idle]
            return [w.proc.pid for w in live]

    def shutdown(self):
        super().shutdown()              # poison the local threads first
        with self._pcond:
            workers = list(self._all)
            self._all.clear()
            self._free.clear()
            self._total = 0
        for w in workers:
            try:
                with w.send_lock:
                    w.conn.send(("stop",))
            except (OSError, ValueError):
                pass
        for w in workers:
            w.proc.join(timeout=1.0)
            self._close(w)
            self._shm_reap(w.proc.pid)
        self._seg_cache.close()


# ----------------------------- child side -------------------------------- #
class _RemoteCheckpoint:
    """Child-side Checkpoint proxy: same interface the body sees inproc
    (restore/save/preempt_requested), backed by the pipe.  ``save``
    blocks for the parent's ack so persist-then-raise survives the
    boundary."""

    def __init__(self, conn, key: str, seq: int, snapshot):
        self.key = key
        self._conn = conn
        self._seq = seq
        self._snapshot = snapshot       # (step, state) shipped with "run"
        self._preempt = False

    def restore(self):
        return self._snapshot

    def save(self, step: int, state):
        blob, _ = serializer.pack_result(state)     # None = cannot cross;
        self._conn.send(("save", self._seq, step, blob))  # parent skips
        while True:                                       # the persist
            msg = self._conn.recv()
            if msg[0] == "save_ack" and msg[1] == self._seq:
                if msg[2] or self._preempt:
                    self._preempt = True
                    raise TaskPreempted(self.key, step)
                return
            if msg[0] == "preempt":
                if msg[1] == self._seq:
                    self._preempt = True
                continue                # stale seq: a prior run's flag

    def preempt_requested(self) -> bool:
        while self._conn.poll(0):       # drain any pending preempt flag;
            msg = self._conn.recv()     # no ack is outstanding here, so
            if msg[0] == "preempt" and msg[1] == self._seq:
                self._preempt = True    # only "preempt" can be queued
        return self._preempt


def _proc_worker_main(conn):
    """Worker-process entry: one run at a time, reused across tasks."""
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError, KeyboardInterrupt):
            return
        if msg[0] == "stop":
            conn.close()
            return
        if msg[0] != "run":
            continue                    # stale preempt from a finished run
        _, seq, payload, checkpointable, key, snapshot, shm_thresh = msg
        attached = []
        try:
            fn, args, kwargs = serializer.loads(payload)
            args, kwargs = _shm_rehydrate(args, kwargs, attached)
            if checkpointable:
                snap = None
                if snapshot is not None:
                    snap = (snapshot[0], serializer.loads(snapshot[1]))
                kwargs["ckpt"] = _RemoteCheckpoint(conn, key, seq, snap)
            result = fn(*args, **kwargs)
            if not _shm_ship_result(conn, seq, result, shm_thresh):
                blob, degraded = serializer.pack_result(result)
                if blob is None:
                    conn.send(("done_raw", seq, degraded))
                else:
                    conn.send(("done", seq, blob))
        except TaskPreempted as e:
            conn.send(("preempted", seq, e.step))
        except KeyboardInterrupt:
            return
        except BaseException as e:      # noqa: BLE001 — ship it back whole
            try:
                conn.send(("error", seq, serializer.pack_exception(e)))
            except (OSError, ValueError):
                return                  # parent is gone
        finally:
            for seg in attached:        # close our mapping of the
                try:                    # parent's argument segments —
                    seg.close()         # the parent unlinks them
                except OSError:
                    pass


def _shm_rehydrate(args, kwargs, attached):
    """Child-side inverse of ``_shm_substitute``: attach each _ShmLeaf's
    segment and hand the body a *read-only* zero-copy view (the buffer is
    owned by the parent; a body that wants to mutate copies first).  A
    tensor leaf becomes a tensor over a copy-on-write map of the segment:
    zero-copy to read, and a write never reaches the parent's buffer."""
    def hydrate(v):
        if isinstance(v, _ShmLeaf):
            seg = _shm_attach_child(v.name, private=v.tensor)
            attached.append(seg)
            arr = _np.ndarray(v.shape, dtype=v.dtype, buffer=seg.buf)
            if v.tensor:
                return _as_tensor(arr)
            if arr.flags.writeable:     # PROT_READ maps arrive read-only
                arr.flags.writeable = False
            return arr
        return v

    return (tuple(hydrate(v) for v in args),
            {k: hydrate(v) for k, v in kwargs.items()})


def _shm_ship_result(conn, seq, result, threshold) -> bool:
    """Ship a large ndarray (or CPU tensor) result through shared memory:
    one memcpy into a segment named for (pid, seq) — so the parent can
    reap it if we die before it copies out — and a tiny metadata message.
    Returns False when the result should take the pickle path instead."""
    arr = None if threshold is None else _shm_view(result, threshold)
    if arr is None:
        return False
    try:
        leaf, seg = _shm_park_child(
            arr, name=f"{_SHM_PREFIX}r{os.getpid()}_{seq}",
            tensor=arr is not result)
    except OSError:
        return False                    # /dev/shm full or absent: pickle
    try:
        conn.send(("done_shm", seq, (leaf.name, leaf.shape, leaf.dtype,
                                     leaf.tensor)))
    except BaseException:               # noqa: BLE001 — parent gone: no
        _shm_release([seg])             # one will ever unlink it but us
        raise
    seg.close()                         # ownership moved to the parent,
    return True                         # which unlinks after copy-out


# ------------------------------- factory ---------------------------------- #
TRANSPORTS = ("inproc", "proc")


def make_transport(name: Optional[str], max_workers: int = 32,
                   idle_s: float = 30.0,
                   start_method: Optional[str] = None,
                   shm_threshold: Optional[int] = None):
    """Build a transport from a PilotDescription's knobs."""
    if name in (None, "inproc"):
        return InprocTransport(max_workers, idle_s)
    if name == "proc":
        return ProcessTransport(max_workers, idle_s, start_method,
                                shm_threshold=shm_threshold)
    raise ValueError(
        f"unknown transport {name!r}; expected one of {TRANSPORTS}")
