"""SPMDWorld — a pilot's persistent ``torch.distributed`` world of rank
processes: the paper's MPI world with its cached Intra-communicators.

A pilot described with ``ranks=N`` starts N rank processes (``spawn``:
the parent may already hold a CUDA context) that join one process group
through a ``FileStore`` in a temporary directory.  Rank ``r`` runs on
``devices[r % len(devices)]``; the backend is NCCL when the ranks' CUDA
devices are distinct, gloo otherwise (the CPU, or several ranks sharing a
card).  The world lives as long as its pilot.

Each ``spmd`` task goes to every rank of its slot block.  A rank builds
the block's process groups the first time it sees the block — the whole
block, then one group per mesh axis, with ``use_local_synchronization``
so that blocks elsewhere in the world need not join — and caches them.
With the cache off (``run(cache=False)``: the paper's cold-communicator
ablation) every task builds its own, and once every rank of the block
has finished the body the parent has them destroy those groups (later,
while a DTensor the ranks hold is laid over them), so a long ablation
holds no more communicators than a short one.  The body
runs on a ``SubMesh`` that carries the groups and their ``DeviceMesh``.

Compiled bodies.  A task that asks for ``jit`` carries the parent's key
for it, (``id(fn)``, the block's key): each rank unpickles a new function
object for every task, so it cannot key a cache on the function itself.
The first task of a key wraps the body in ``torch.compile`` in each rank
(it compiles at its first call), and the rank keeps the wrapper beside the
block's groups; later tasks of the key call it.  Python float arguments
reach a compiled body as 0-d tensors, as ``jax.jit`` traces them (``_jit``).
With the cache off every task compiles anew.  Each call's record says how
many graphs dynamo compiled in the rank while it ran (``graphs``, the most
over the block's ranks; ``compiled`` if any): one key's first task
compiles, its later tasks none unless dynamo recompiles.  ``calls`` holds
the records in the world's dispatch order (each carries its ``seq``),
whichever parent thread gathers its replies first.

Order.  One dispatcher lock puts each task on the outbound queue of every
rank of its block, so all ranks see the tasks in one global order and two
tasks that share ranks can never wait on each other in opposite orders.
Each rank runs its tasks one at a time in that order; tasks on disjoint
blocks run at the same time.

Results stay where they were made.  Every tensor leaf of a result is kept
in each rank's memory under a key; the parent gets a ``RankRef`` (block,
key, shape, dtype, placement; no data).  A ``RankRef`` handed to a later
task on the same block resolves inside the ranks without crossing; handed
to a Python or bash task, or asked with ``fetch()``, it comes to the host
(rank 0's tensor, or ``full_tensor()`` of a DTensor).  The ranks drop the
tensor when the parent's last ``RankRef`` to it dies, and at close.
Everything else in a result comes back by value through the serializer,
which counts the tensor bytes that cross (``stats``).

Faults.  A rank that dies (EOF on its pipe) fails its tasks with
``WorkerDied``, whatever its peers report first; a rank that raises fails
its task with that rank's traceback.  Either way the world is killed at
once (a peer may be stuck in a collective the dead rank will never join),
and the next task restarts it; its cached groups and ``RankRef``s are
gone and raise ``StaleRankRef`` on use.  The process groups use a short
timeout (``PG_TIMEOUT_S``), so a collective that can never complete fails
its task instead of hanging it.  Start, restart and stop are journal events.
Ranks that share a card (gloo on CUDA tensors) route DTensor's all-gathers
through the c10d call (``_gather_through_c10d``): gloo's functional one
crashes there.

Checkpointable bodies keep the process transport's contract on every rank
of the block: ``ckpt.restore()`` is the snapshot shipped with the task;
``ckpt.save`` on the block's first rank sends the state, and every rank of
the block blocks until the parent has persisted it and acked with the
preempt flag, so all of them continue or unwind with ``TaskPreempted``
together.

Protocol (parent → rank, through one sender thread per rank):
  ("run", seq, blob, ranks, shape, cache, ckpt, compile_key)
  ("fetch", seq, ranks, keys)
  ("free", keys)        ("drop", seq)        ("save_ack", seq, preempt)
  ("stop",)
rank → parent (read by one reader thread per rank):
  ("ready", rank, pid)
  ("done", seq, rank, blob, info)    blob from the block's first rank only
  ("save", seq, rank, step, blob)    ("preempted", seq, rank, step)
  ("error", seq, rank, exc_blob)
"""
from __future__ import annotations

import collections
import itertools
import multiprocessing
import os
import queue
import shutil
import tempfile
import threading
import time
import weakref
from datetime import timedelta
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from . import serializer
from .checkpoint import TaskPreempted
from .spmd_executor import SubMesh
from .store import EVENTS
from .transport import WorkerDied

PG_TIMEOUT_S = 60.0                 # a collective that cannot complete
                                    # fails its task after this long
START_TIMEOUT_S = 600.0             # the ranks' start, CUDA init included

_STOP = ("stop",)


class StaleRankRef(RuntimeError):
    """A ``RankRef`` whose tensor is gone: freed, or held by a world that
    has since been restarted or closed."""


class _RefKey:
    """A ``RankRef`` as it crosses to the ranks of its own block: the key
    of the tensor each rank holds."""

    __slots__ = ("key",)

    def __init__(self, key):
        self.key = key

    def __getstate__(self):
        return self.key

    def __setstate__(self, key):
        self.key = key


class _LeafMeta:
    """What a rank reports of a result's tensor leaf."""

    __slots__ = ("key", "shape", "dtype", "device", "placement")

    def __init__(self, key, t: torch.Tensor):
        self.key = key
        self.shape = tuple(t.shape)
        self.dtype = t.dtype
        self.device = str(t.device)
        self.placement = (tuple(str(p) for p in t.placements)
                          if hasattr(t, "placements") else None)

    def __getstate__(self):
        return (self.key, self.shape, self.dtype, self.device, self.placement)

    def __setstate__(self, s):
        self.key, self.shape, self.dtype, self.device, self.placement = s


class RankRef:
    """A tensor that a world task returned, held in its block's ranks.
    ``fetch()`` brings it to the host; so does ``float()``, as for a
    sharded ``jax.Array``."""

    __slots__ = ("world", "gen", "ranks", "key", "shape", "dtype", "device",
                 "placement", "__weakref__")

    def __init__(self, world: "SPMDWorld", gen: int, ranks: Tuple[int, ...],
                 meta: _LeafMeta):
        self.world, self.gen, self.ranks = world, gen, ranks
        self.key, self.shape, self.dtype = meta.key, meta.shape, meta.dtype
        self.device, self.placement = meta.device, meta.placement
        fin = weakref.finalize(self, world._release, gen, ranks, meta.key)
        fin.atexit = False

    def fetch(self) -> torch.Tensor:
        return self.world.fetch([self])[0]

    def __float__(self):
        return float(self.fetch())

    def __reduce__(self):
        raise TypeError("a RankRef does not cross a process boundary: "
                        "fetch() it")

    def __repr__(self):
        where = f", {self.placement}" if self.placement else ""
        return (f"RankRef(ranks {self.ranks}, {tuple(self.shape)} "
                f"{self.dtype} on {self.device}{where})")


def _map(x, fn):
    """``x`` with ``fn`` applied to every leaf inside dicts, lists and
    tuples (NamedTuples included); containers are rebuilt only where a
    leaf changed."""
    if isinstance(x, dict):
        out = {k: _map(v, fn) for k, v in x.items()}
        return x if all(out[k] is x[k] for k in x) else out
    if isinstance(x, (list, tuple)):
        out = [_map(v, fn) for v in x]
        if all(a is b for a, b in zip(out, x)):
            return x
        if isinstance(x, list):
            return out
        return type(x)(*out) if hasattr(x, "_fields") else type(x)(out)
    return fn(x)


def _refs_in(x) -> List[RankRef]:
    found: List[RankRef] = []
    _map(x, lambda v: found.append(v) if isinstance(v, RankRef) else v)
    return found


def fetch_refs(x):
    """``x`` with every ``RankRef`` inside it brought to the host, one
    fetch per block."""
    refs = _refs_in(x)
    if not refs:
        return x
    got: Dict[int, Any] = {}
    by_block: Dict[Tuple, List[RankRef]] = {}
    for r in refs:
        by_block.setdefault((id(r.world), r.ranks), []).append(r)
    for block in by_block.values():
        for r, v in zip(block, block[0].world.fetch(block)):
            got[id(r)] = v
    return _map(x, lambda v: got[id(v)] if isinstance(v, RankRef) else v)


def _backend(devices: Sequence[torch.device]) -> str:
    """NCCL when every rank has a CUDA device of its own, gloo else."""
    if (all(d.type == "cuda" for d in devices)
            and len({d.index for d in devices}) == len(devices)):
        return "nccl"
    return "gloo"


class _Handle:
    """The parent's side of one rank process."""

    __slots__ = ("rank", "gen", "proc", "conn", "outq", "threads")

    def __init__(self, rank, gen, proc, conn):
        self.rank, self.gen, self.proc, self.conn = rank, gen, proc, conn
        self.outq: "queue.SimpleQueue" = queue.SimpleQueue()
        self.threads: List[threading.Thread] = []


class _Call:
    __slots__ = ("gen", "ranks", "inbox", "procs")

    def __init__(self, gen, ranks):
        self.gen, self.ranks = gen, ranks
        self.inbox: "queue.SimpleQueue" = queue.SimpleQueue()
        self.procs: list = []           # the block's rank processes


class SPMDWorld:
    """N rank processes in one ``torch.distributed`` world, for the life of
    a pilot.  ``run`` executes a body on a block of ranks; ``fetch`` brings
    ``RankRef``s to the host; ``close`` stops the ranks."""

    def __init__(self, n_ranks: int, devices: Sequence[torch.device],
                 store=None, owner: Optional[str] = None):
        if n_ranks < 1:
            raise ValueError(f"a world needs at least one rank, got {n_ranks}")
        # a card named without an index is card 0, as torch places it
        devices = [torch.device("cuda", 0) if torch.device(d) == torch.device(
            "cuda") else torch.device(d) for d in devices]
        if not devices:
            raise ValueError("a world needs at least one device")
        self.n = n_ranks
        self.rank_devices = [devices[r % len(devices)] for r in range(n_ranks)]
        self.backend = _backend(self.rank_devices)
        self.store = store              # StateStore for the journal events
        self.owner = owner
        self._mp = multiprocessing.get_context("spawn")
        self._life = threading.Lock()       # start / restart / close
        self._dispatch = threading.Lock()   # the global task order
        self._calls_lock = threading.Lock()
        self._calls: Dict[int, _Call] = {}
        self._seq = itertools.count(1)
        self._handles: List[_Handle] = []
        self._dir: Optional[str] = None
        self.gen = 0
        self._broken: Optional[str] = None  # why the world must restart
        self._closed = False
        self.stats = {"tasks": 0, "fetches": 0, "restarts": 0,
                      "tensor_bytes_to_ranks": 0, "tensor_bytes_from_ranks": 0}
        self.calls: collections.deque = collections.deque(maxlen=4096)
        with self._life:
            self._record_start(self._start())

    # ------------------------------ lifecycle ---------------------------- #
    def _start(self):
        """Spawn the ranks and wait until each has joined (caller holds
        ``_life``)."""
        t0 = time.monotonic()
        self.gen += 1
        self._dir = tempfile.mkdtemp(prefix="rpx_world_")
        store = os.path.join(self._dir, "store")
        handles = []
        for r in range(self.n):
            parent, child = self._mp.Pipe(duplex=True)
            p = self._mp.Process(
                target=_rank_main, daemon=True,
                args=(r, self.n, store, str(self.rank_devices[r]),
                      self.backend, child))
            p.start()
            child.close()
            handles.append(_Handle(r, self.gen, p, parent))
        deadline = time.monotonic() + START_TIMEOUT_S
        try:
            for h in handles:
                while not h.conn.poll(0.5):
                    if not h.proc.is_alive() or time.monotonic() > deadline:
                        raise WorkerDied(
                            f"rank {h.rank} did not join the world (exit "
                            f"code {h.proc.exitcode})")
                msg = h.conn.recv()
                if msg[0] != "ready":
                    raise WorkerDied(f"rank {h.rank} failed to start:\n"
                                     f"{msg[-1]}")
        except (EOFError, OSError, WorkerDied) as e:
            self._kill(handles)
            shutil.rmtree(self._dir, ignore_errors=True)
            if isinstance(e, WorkerDied):
                raise
            raise WorkerDied("a rank died while the world started") from e
        for h in handles:
            for target in (self._sender, self._reader):
                th = threading.Thread(target=target, args=(h,), daemon=True)
                h.threads.append(th)
                th.start()
        self._handles = handles
        self._broken = None
        return time.monotonic() - t0

    def _record_start(self, seconds: float, restart_reason=None):
        if self.store is None:
            return
        if restart_reason is None:
            self.store.record_event(EVENTS.WORLD_START, pilot=self.owner,
                                    ranks=self.n, backend=self.backend,
                                    pids=self.pids(), seconds=seconds)
        else:
            self.store.record_event(EVENTS.WORLD_RESTART, pilot=self.owner,
                                    ranks=self.n, backend=self.backend,
                                    pids=self.pids(), seconds=seconds,
                                    gen=self.gen, reason=restart_reason)

    def _ensure_live(self) -> int:
        """The live generation, restarting a broken world first."""
        with self._life:
            if self._closed:
                raise RuntimeError("the world is closed")
            if self._broken is not None:
                reason = self._broken
                self._teardown(self._handles)
                self.stats["restarts"] += 1
                self._record_start(self._start(), restart_reason=reason)
            return self.gen

    def _break(self, reason: str, gen: int):
        """Kill generation ``gen`` at once: a peer of a failed rank may be
        stuck in a collective.  The next task restarts the world."""
        with self._calls_lock:
            if gen != self.gen or self._broken is not None:
                return
            self._broken = reason
            handles = list(self._handles)
        self._kill(handles)

    @staticmethod
    def _kill(handles):
        for h in handles:
            if h.proc.is_alive():
                h.proc.kill()
        for h in handles:
            h.outq.put(_STOP)

    def _teardown(self, handles, graceful: bool = False):
        if graceful:
            for h in handles:
                h.outq.put(_STOP)           # the sender forwards it, then
            deadline = time.monotonic() + 10.0      # ends
            for h in handles:
                h.proc.join(max(0.1, deadline - time.monotonic()))
        self._kill(handles)
        for h in handles:
            h.proc.join(5.0)
            try:
                h.conn.close()
            except OSError:
                pass
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None

    def kill(self, reason: str = "pilot lost"):
        """Kill the ranks now (a lost pilot); in-flight tasks fail with
        ``WorkerDied``."""
        self._break(reason, self.gen)

    def close(self):
        with self._life:
            if self._closed:
                return
            self._closed = True
            with self._calls_lock:
                self._broken = self._broken or "closed"
            self._teardown(self._handles, graceful=True)
        if self.store is not None:
            self.store.record_event(EVENTS.WORLD_STOP, pilot=self.owner,
                                    ranks=self.n,
                                    restarts=self.stats["restarts"],
                                    tasks=self.stats["tasks"])

    def pids(self) -> List[int]:
        return [h.proc.pid for h in self._handles if h.proc.is_alive()]

    # ------------------------------- threads ----------------------------- #
    @staticmethod
    def _sender(h: _Handle):
        while True:
            msg = h.outq.get()
            try:
                h.conn.send(msg)
            except (OSError, ValueError):
                return
            if msg is _STOP:
                return

    def _reader(self, h: _Handle):
        while True:
            try:
                msg = h.conn.recv()
            except (EOFError, OSError):
                break
            with self._calls_lock:
                call = self._calls.get(msg[1])
            if call is not None:
                call.inbox.put(msg)
        code = h.proc.exitcode if not h.proc.is_alive() else None
        self._break(f"rank {h.rank} died (exit code {code})", h.gen)
        with self._calls_lock:
            pending = [c for c in self._calls.values() if c.gen == h.gen]
        for c in pending:
            c.inbox.put(("died", None, h.rank, code))

    # ------------------------------ dispatch ----------------------------- #
    def _post(self, ranks: Tuple[int, ...], gen: int, make_msg) -> Tuple[int, _Call]:
        """Queue one message on every rank of ``ranks`` in the global
        order; ``make_msg(seq)`` builds it."""
        call = _Call(gen, ranks)
        with self._dispatch:
            with self._calls_lock:
                if gen != self.gen or self._broken is not None:
                    raise WorkerDied(f"the world ended before the task was "
                                     f"sent ({self._broken})")
                seq = next(self._seq)
                self._calls[seq] = call
                handles = [self._handles[r] for r in ranks]
                call.procs = [h.proc for h in handles]
            msg = make_msg(seq)
            for h in handles:
                h.outq.put(msg)
        return seq, call

    def _wait(self, seq: int, call: _Call, what: str, ckpt=None,
              key: Optional[str] = None) -> Dict[int, tuple]:
        """Every rank's terminal message for ``seq``, by rank."""
        replies: Dict[int, tuple] = {}
        try:
            while len(replies) < len(call.ranks):
                msg = call.inbox.get()
                tag = msg[0]
                if tag == "save":
                    _, _, _, step, blob = msg
                    if ckpt is not None and blob is not None:
                        ckpt.store.save(key, step, serializer.loads(blob))
                    ack = ("save_ack", seq,
                           ckpt is not None and ckpt.preempt_requested())
                    for r in call.ranks:
                        self._handles[r].outq.put(ack)
                elif tag == "died":
                    raise WorkerDied(f"rank {msg[2]} died (exit code "
                                     f"{msg[3]}) while running {what}")
                elif tag == "error":
                    self._break(f"rank {msg[2]} raised in {what}", call.gen)
                    err = serializer.unpack_exception(msg[3])
                    # a peer of a rank that died fails in its collective,
                    # and its error may come before the death is seen
                    dead = [r for r, p in zip(call.ranks, call.procs)
                            if not p.is_alive()]
                    if dead:
                        raise WorkerDied(f"rank {dead[0]} died while running "
                                         f"{what}") from err
                    raise err
                else:
                    replies[msg[2]] = msg
        finally:
            with self._calls_lock:
                self._calls.pop(seq, None)
        tags = {m[0] for m in replies.values()}
        if tags == {"preempted"}:
            raise TaskPreempted(key, replies[call.ranks[0]][3])
        if tags != {"done"}:
            self._break(f"ranks ended {what} apart: {sorted(tags)}", call.gen)
            raise RuntimeError(f"the ranks of {what} did not unwind "
                               f"together: {sorted(tags)}")
        return replies

    def run(self, fn, args: tuple, kwargs: dict, ranks: Sequence[int],
            shape: Tuple[int, int], uid: Optional[str] = None, ckpt=None,
            cache: bool = True, compile_key=None):
        """``fn(mesh, *args, **kwargs)`` on every rank of ``ranks`` as a
        ``shape`` block; its result, with each tensor leaf a ``RankRef``.
        ``ckpt``, a task's Checkpoint context, reaches the body as its
        ``ckpt`` keyword through the ranks' proxies.  With ``cache``
        False the ranks build the block's groups for this task alone and
        destroy them once every rank has finished it.  With a
        ``compile_key`` the ranks call the body through ``torch.compile``,
        compiled once per key (with ``cache`` False, for this task)."""
        t0 = time.perf_counter()
        ranks = tuple(ranks)
        gen = self._ensure_live()
        args, kwargs = self._encode((args, kwargs), ranks, gen)
        counted: Dict[str, int] = {}
        blob = serializer.dumps((fn, args, kwargs), counted)
        snapshot = None
        key = None
        if ckpt is not None:
            key = ckpt.key
            got = ckpt.restore()
            if got is not None:
                snapshot = (got[0], serializer.dumps(got[1], counted))
        what = f"task {uid or getattr(fn, '__name__', fn)}"
        seq, call = self._post(ranks, gen, lambda seq: (
            "run", seq, blob, ranks, tuple(shape), cache,
            None if ckpt is None else (key, snapshot), compile_key))
        try:
            replies = self._wait(seq, call, what, ckpt, key)
        finally:
            if not cache:
                # every rank has left the body (or the world is broken,
                # and _send_live sends nothing); in the global order, as
                # NCCL's teardown may wait for the group's peers
                with self._dispatch:
                    self._send_live(gen, ranks, ("drop", seq))
        lead = replies[ranks[0]]
        out = _map(serializer.loads(lead[3]), lambda v: RankRef(
            self, gen, ranks, v) if isinstance(v, _LeafMeta) else v)
        info = [m[4] for m in replies.values()]
        back = sum(i["tensor_bytes"] for i in info)
        sent = counted.get("tensor_bytes", 0) * len(ranks)
        with self._calls_lock:
            self.stats["tasks"] += 1
            self.stats["tensor_bytes_to_ranks"] += sent
            self.stats["tensor_bytes_from_ranks"] += back
            self._record({
                "seq": seq, "uid": uid, "ranks": ranks,
                "call_s": time.perf_counter() - t0,
                "body_s": max(i["body_s"] for i in info),
                "groups_s": max(i["groups_s"] for i in info),
                "reap_s": max(i["reap_s"] for i in info),
                "built": any(i["built"] for i in info),
                "graphs": max(i["graphs"] for i in info),
                "compiled": any(i["graphs"] for i in info),
                "held": max(i["held"] for i in info),
                "tensor_bytes_to_ranks": sent,
                "tensor_bytes_from_ranks": back})
        return out

    def _record(self, rec: dict) -> None:
        """Put a call's record into ``calls`` at its place in the dispatch
        order (caller holds ``_calls_lock``).  The ranks run tasks in that
        order, but the parent threads that gather their replies finish in
        any order, so a record may come after a later task's."""
        calls = self.calls
        if len(calls) == calls.maxlen:
            calls.popleft()
        i = len(calls)
        while i and calls[i - 1]["seq"] > rec["seq"]:
            i -= 1
        calls.insert(i, rec)

    def fetch(self, refs: Sequence[RankRef]) -> List[torch.Tensor]:
        """The tensors of ``refs`` (all of one block) on the host."""
        refs = list(refs)
        ranks = refs[0].ranks
        if any(r.ranks != ranks or r.world is not self for r in refs):
            raise ValueError("fetch takes RankRefs of one block")
        if self._closed:
            raise StaleRankRef(f"{refs[0]} belongs to a closed world")
        gen = self._ensure_live()
        stale = [r for r in refs if r.gen != gen]
        if stale:
            raise StaleRankRef(f"{stale[0]} belongs to a world that has "
                               "been restarted or closed")
        keys = [r.key for r in refs]
        seq, call = self._post(ranks, gen,
                               lambda seq: ("fetch", seq, ranks, keys))
        replies = self._wait(seq, call, f"a fetch of {len(keys)} tensors")
        lead = replies[ranks[0]]
        with self._calls_lock:
            self.stats["fetches"] += 1
            self.stats["tensor_bytes_from_ranks"] += lead[4]["tensor_bytes"]
        return serializer.loads(lead[3])

    def _encode(self, x, ranks, gen):
        """RankRefs of this block stay keys; any other comes to the host
        (and crosses by value)."""
        refs = _refs_in(x)
        for r in refs:
            if r.world is self and r.gen != gen:
                raise StaleRankRef(f"{r} belongs to a world that has been "
                                   "restarted or closed")
        foreign = [r for r in refs
                   if not (r.world is self and r.ranks == ranks)]
        host = {id(r): v for r, v in zip(foreign, fetch_refs(foreign))}

        def encode(v):
            if not isinstance(v, RankRef):
                return v
            return host[id(v)] if id(v) in host else _RefKey(v.key)
        return _map(x, encode)

    def _release(self, gen: int, ranks: Tuple[int, ...], key):
        """A RankRef died: its ranks drop the tensor.  Runs from a weakref
        callback, so it only puts on the (reentrant) outbound queues."""
        self._send_live(gen, ranks, ("free", (key,)))

    def _send_live(self, gen: int, ranks: Tuple[int, ...], msg):
        """Queue ``msg``, which needs no reply, on ``ranks`` of generation
        ``gen`` if it still lives."""
        handles = self._handles
        if gen != self.gen or self._broken is not None:
            return
        for r in ranks:
            handles[r].outq.put(msg)


# ------------------------------ rank side -------------------------------- #
class _RankCheckpoint:
    """The body's ``ckpt`` on a rank: the block's first rank sends each
    save; every rank waits for the parent's ack and its preempt flag."""

    def __init__(self, rank: "_Rank", seq: int, key: str, lead: bool,
                 snapshot):
        self.key = key
        self._rank, self._seq, self._lead = rank, seq, lead
        self._snapshot = snapshot
        self._preempt = False

    def restore(self):
        return self._snapshot

    def save(self, step: int, state):
        if self._lead:
            blob, _ = serializer.pack_result(state)
            self._rank.conn.send(("save", self._seq, self._rank.rank, step,
                                  blob))
        while True:
            msg = self._rank.acks.get()
            if msg[1] == self._seq:
                break
        if msg[2]:
            self._preempt = True
            raise TaskPreempted(self.key, step)

    def preempt_requested(self) -> bool:
        """The flag as of the last ack: the same on every rank."""
        return self._preempt


class _Rank:
    """One rank's loop: tasks in the order the parent sent them."""

    def __init__(self, rank: int, world: int, device: torch.device, conn):
        self.rank, self.world, self.device, self.conn = (rank, world, device,
                                                         conn)
        self.refs: Dict[Any, torch.Tensor] = {}
        self.meshes: Dict[Tuple, SubMesh] = {}
        self.cold: Dict[int, SubMesh] = {}     # uncached groups, by task
        self.states: Dict[Tuple, dict] = {}    # each block's ``state``
        self.dropping: set = set()              # ... whose task has ended
        self.reap_s = 0.0       # spent destroying them since the last reply
        self.inbox: "queue.SimpleQueue" = queue.SimpleQueue()
        self.acks: "queue.SimpleQueue" = queue.SimpleQueue()
        self.built: Dict[Tuple[int, ...], int] = {}    # groups by members
        self.compiled: Dict[Any, Any] = {}  # torch.compile'd bodies, by key

    def receive(self):
        while True:
            try:
                msg = self.conn.recv()
            except (EOFError, OSError):
                self.inbox.put(_STOP)
                return
            if msg[0] == "save_ack":
                self.acks.put(msg)
            else:
                self.inbox.put(msg)
                if msg[0] == "stop":
                    return

    def new_group(self, members: Tuple[int, ...]):
        """A process group of ``members``, named by the world.

        ``new_group(use_local_synchronization=True)`` names a group by a
        hash of its members and of the number of groups this process
        holds, which differs between ranks whose blocks differ, and ranks
        that disagree on a name never meet.  The world names it instead:
        its members and how many times they have built a group together,
        which every member counts alike (each task reaches every rank of
        its block, in one order)."""
        n = self.built.get(members, 0) + 1
        self.built[members] = n
        return _named_group(members, f"rpx{'_'.join(map(str, members))}#{n}")

    def submesh(self, seq, ranks, shape,
                cache) -> Tuple[SubMesh, float, bool]:
        key = (ranks, shape)
        if cache and key in self.meshes:
            return self.meshes[key], 0.0, False
        t0 = time.perf_counter()
        grid = [ranks[i * shape[1]:(i + 1) * shape[1]]
                for i in range(shape[0])]
        i, j = divmod(ranks.index(self.rank), shape[1])
        groups = {None: self.new_group(ranks)}
        for axis, members in (("data", tuple(row[j] for row in grid)),
                              ("model", grid[i])):
            groups[axis] = (groups[None] if members == ranks
                            else self.new_group(members))
        mesh = SubMesh([self.device] * len(ranks), shape,
                       rank=ranks.index(self.rank), ranks=ranks, groups=groups,
                       state=self.states.setdefault(key, {}))
        if cache:
            self.meshes[key] = mesh
        else:
            self.cold[seq] = mesh
        return mesh, time.perf_counter() - t0, True

    def reap(self):
        """Destroy the groups that tasks built with the cache off, once
        every rank of the task's block has finished it and no tensor the
        rank holds is a DTensor over them."""
        import torch.distributed as dist
        if not self.dropping:
            return
        used = {id(g) for t in self.refs.values() if hasattr(t, "device_mesh")
                for g in t.device_mesh.get_all_groups()}
        t0 = time.perf_counter()
        for seq in list(self.dropping):
            groups = {id(g): g for g in self.cold[seq]._groups.values()}
            if used.isdisjoint(groups):
                self.dropping.discard(seq)
                del self.cold[seq]
                for group in groups.values():
                    dist.destroy_process_group(group)
        self.reap_s += time.perf_counter() - t0

    def resolve(self, x):
        def get(v):
            if not isinstance(v, _RefKey):
                return v
            try:
                return self.refs[v.key]
            except KeyError:
                raise StaleRankRef(f"rank {self.rank} holds no tensor "
                                   f"{v.key}: it was freed") from None
        return _map(x, get)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def body(self, fn, key, cache):
        """The callable to run ``fn`` through: ``fn`` itself without a key,
        else its compiled wrapper (``_jit``), kept under the parent's key."""
        if key is None:
            return fn
        if cache and key in self.compiled:
            return self.compiled[key]
        wrapped = _jit(fn)
        if cache:
            self.compiled[key] = wrapped
        return wrapped

    def run(self, msg):
        _, seq, blob, ranks, shape, cache, ckpt, compile_key = msg
        lead = ranks[0] == self.rank
        mesh, groups_s, built = self.submesh(seq, ranks, shape, cache)
        fn, args, kwargs = serializer.loads(blob)
        fn = self.body(fn, compile_key, cache)
        args, kwargs = self.resolve((args, kwargs))
        if ckpt is not None:
            key, snap = ckpt
            if snap is not None:
                snap = (snap[0], serializer.loads(snap[1]))
            kwargs["ckpt"] = _RankCheckpoint(self, seq, key, lead, snap)
        graphs = _graphs_compiled() if compile_key is not None else 0
        t0 = time.perf_counter()
        out = fn(mesh, *args, **kwargs)
        self.sync()
        body_s = time.perf_counter() - t0
        if compile_key is not None:
            graphs = _graphs_compiled() - graphs
        n = itertools.count()

        def keep(v):
            if not isinstance(v, torch.Tensor):
                return v
            k = (seq, next(n))
            self.refs[k] = v
            return _LeafMeta(k, v)
        out = _map(out, keep)
        counted: Dict[str, int] = {}
        payload = serializer.dumps(out, counted) if lead else None
        self.conn.send(("done", seq, self.rank, payload, {
            "body_s": body_s, "groups_s": groups_s, "built": built,
            "graphs": graphs,
            "held": len(self.refs), "reap_s": self.reap_s,
            "tensor_bytes": counted.get("tensor_bytes", 0)}))
        self.reap_s = 0.0

    def fetch(self, msg):
        _, seq, ranks, keys = msg
        vals = []
        for k in keys:
            t = self.resolve(_RefKey(k))
            vals.append(t.full_tensor() if hasattr(t, "full_tensor") else t)
        self.sync()
        counted: Dict[str, int] = {}
        payload = (serializer.dumps(vals, counted) if ranks[0] == self.rank
                   else None)
        self.conn.send(("done", seq, self.rank, payload,
                        {"tensor_bytes": counted.get("tensor_bytes", 0)}))

    def loop(self):
        threading.Thread(target=self.receive, daemon=True).start()
        while True:
            msg = self.inbox.get()
            tag = msg[0]
            if tag == "stop":
                return
            if tag == "free":
                for k in msg[1]:
                    self.refs.pop(k, None)
                self.reap()
                continue
            if tag == "drop":
                if msg[1] in self.cold:
                    self.dropping.add(msg[1])
                self.reap()
                continue
            seq = msg[1]
            try:
                (self.run if tag == "run" else self.fetch)(msg)
            except TaskPreempted as e:
                self.conn.send(("preempted", seq, self.rank, e.step))
            except Exception as e:          # noqa: BLE001 — ship it whole
                self.conn.send(("error", seq, self.rank,
                                serializer.pack_exception(e)))


def _named_group(members: Tuple[int, ...], name: str):
    """``dist.new_group(members)`` with local synchronization, under
    ``name``.

    torch offers no public way to name a group: ``new_group`` takes its
    name from the private ``distributed_c10d._process_group_name(ranks,
    use_hashed_name)``, which this replaces while it runs (checked
    against torch 2.11 and 2.13).  The swap is process-wide, which is safe
    because a rank builds its groups on its one task thread.  If torch
    names groups another way, the name check below raises at the first
    group instead of letting ranks that disagree on a name wait for each
    other."""
    import torch.distributed as dist
    import torch.distributed.distributed_c10d as c10d
    hashed = getattr(c10d, "_process_group_name", None)
    if hashed is None:
        raise RuntimeError(f"torch {torch.__version__} has no "
                           "distributed_c10d._process_group_name: the world "
                           "cannot name its groups")
    c10d._process_group_name = lambda ranks, use_hashed_name: name
    try:
        group = dist.new_group(list(members),
                               timeout=timedelta(seconds=PG_TIMEOUT_S),
                               use_local_synchronization=True)
    finally:
        c10d._process_group_name = hashed
    if group.group_name != name:
        raise RuntimeError(f"the group of {members} is named "
                           f"{group.group_name!r}, not {name!r}: torch "
                           f"{torch.__version__} names groups another way")
    return group


def _jit(fn):
    """``fn`` compiled as ``jax.jit`` traces a function: through
    ``torch.compile``, with each Python float argument made a 0-d tensor on
    the block's device (torch's default dtype), so that one key is one
    graph whatever values its tasks pass.  Dynamo guards on a float's
    value, so a float that reaches a tensor op (``torch.as_tensor(x)``)
    would compile the body again for each new value and, past dynamo's
    recompile limit, run it uncompiled."""
    compiled = torch.compile(fn)

    def call(mesh, *args, **kwargs):
        def lift(v):
            return (torch.tensor(v, device=mesh.device) if type(v) is float
                    else v)
        return compiled(mesh, *map(lift, args),
                        **{k: lift(v) for k, v in kwargs.items()})
    return call


def _graphs_compiled() -> int:
    """The graphs dynamo has compiled in this process so far."""
    from torch._dynamo.utils import counters
    return counters["stats"]["unique_graphs"]


def _c10d_all_gather(self: torch.Tensor, gather_dim: int, group,
                     tag: str = "") -> torch.Tensor:
    """``_functional_collectives.all_gather_tensor`` (and ``_single``):
    ``self`` of every rank of ``group`` concatenated along ``gather_dim``,
    through the c10d call ``dist.all_gather_into_tensor``, synchronously.
    ``group`` as DTensor passes it: a (DeviceMesh, dim) pair, a 1-D
    DeviceMesh, a process group or its name."""
    import torch.distributed as dist
    import torch.distributed.distributed_c10d as c10d
    if isinstance(group, tuple):
        group = group[0].get_group(group[1])
    elif isinstance(group, str):
        group = c10d._resolve_process_group(group)
    elif hasattr(group, "get_group"):
        group = group.get_group()
    n = dist.get_world_size(group)
    x = self.contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    if gather_dim != 0:
        out = torch.cat(torch.chunk(out, n, dim=0), dim=gather_dim)
    return out


def _gather_through_c10d():
    """Route this rank's functional all-gathers through ``_c10d_all_gather``.

    Ranks that share a card talk over gloo, and gloo's functional
    all-gather (``_c10d_functional.all_gather_into_tensor``, with which
    DTensor replicates a shard) crashes the process on CUDA tensors, while
    the c10d call of the same name works (torch 2.11, NVIDIA H100).  The
    replacement has the functions' signature and result; a torch without
    them raises here rather than crash in a collective."""
    import torch.distributed._functional_collectives as funcol
    names = [n for n in ("all_gather_tensor", "all_gather_single")
             if hasattr(funcol, n)]
    if "all_gather_tensor" not in names:
        raise RuntimeError(f"torch {torch.__version__} has no "
                           "_functional_collectives.all_gather_tensor to "
                           "route through the c10d call")
    for n in names:
        setattr(funcol, n, _c10d_all_gather)


def _rank_main(rank: int, world: int, store: str, device: str, backend: str,
               conn):
    """A rank process: join the world, then run the parent's tasks."""
    import faulthandler
    import traceback
    import torch.distributed as dist
    faulthandler.enable()               # a crash prints where, on stderr
    dev = torch.device(device)
    timeout = timedelta(seconds=PG_TIMEOUT_S)
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=timeout,
            device_id=dev if backend == "nccl" else None)
        if backend == "gloo" and dev.type == "cuda":
            _gather_through_c10d()
    except Exception:                   # noqa: BLE001 — report, then exit
        conn.send(("failed", rank, traceback.format_exc()))
        return
    conn.send(("ready", rank, os.getpid()))
    try:
        _Rank(rank, world, dev, conn).loop()
    finally:
        try:
            dist.destroy_process_group()
        except Exception:               # noqa: BLE001 — a peer may be gone
            pass
        conn.close()


__all__ = ["PG_TIMEOUT_S", "RankRef", "SPMDWorld", "StaleRankRef",
           "fetch_refs"]
