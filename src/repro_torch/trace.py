"""The port's own spans and counters: one recorder, on the profiler's clock.

``span(name, *, device=False, task=None, lend=False, **attrs)`` times a
region of the program (a context manager); ``count(name, n=1)`` adds to a
counter; ``snapshot()`` returns the last session's spans and counters.

Tracing is on while a ``torch.profiler`` session records anywhere in the
process, or after ``enable()`` until ``disable()``.  The recorder follows
torch's own switch, the functions ``torch.autograd.profiler`` calls as any
of its profilers starts and stops recording, so it is on in every thread at
once.  Each switch from off to on starts a new session, which drops the
last one.  Off, a span costs one flag check: it calls no
``record_function``, allocates nothing and reads no clock.

On, a span records its name; its start and end in ``time.time_ns()``
nanoseconds, the clock of the profiler's events, so that a span lines up
with the profiler's trace; its parent, the enclosing span on its thread;
its task, given where a pilot task's body runs and inherited by every span
inside it; and its thread's native id.  It opens a ``record_function``
range of its own name, so that it shows in the profiler's trace.  (Off,
and inside code that ``torch.compile`` traces, ``with span(...) as sp``
gives ``sp`` None.)  With
``device=True`` it also records CUDA events on the current stream at entry
and exit, read by ``snapshot()`` once the caller has synchronized; without
CUDA its device time is its host time.

Autograd runs a CUDA backward on a thread of its own, where the remat
recompute of a layer runs too.  A span opened on a thread with no open span
of its own, inside a backward, takes as its parent the open span marked
``lend=True`` (``train.backward``, whose thread waits in
``torch.autograd.grad`` meanwhile), and its task, where that span is the
only one open; where several are, as when two tasks run their backwards
at once, it cannot tell whose backward it runs in and takes no parent.

Span names may not start with ``rpx.`` or ``aten::`` nor contain ``cuda``:
those are the benchmark harness's ranges and the host ops its idle labels
read.  Spans go into a bounded buffer; those beyond it are counted as
dropped.  Nothing is written out.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

LIMIT = 1 << 17         # spans a session keeps

_P = torch.autograd.profiler
_graph_task = getattr(torch._C, "_current_graph_task_id", None)


# a span while tracing is off, and inside a function ``torch.compile``
# traces: it enters as None (``with span(...) as sp: if sp: ...``), and
# is a context manager the compiler passes through
_OFF = contextlib.nullcontext()


class Span:
    """One timed region: while open, its context manager; once closed, the
    record a snapshot holds.  ``start_ns`` and ``end_ns`` are on the
    profiler's clock; ``parent`` is a ``Span`` or None."""

    __slots__ = ("name", "id", "parent", "task", "thread", "attrs",
                 "start_ns", "end_ns", "device", "lend", "_rec", "_session",
                 "_events", "_range", "_device_ms")

    def __init__(self, rec, name, device, task, lend, attrs):
        self._rec, self.name, self.device = rec, name, device
        self.task, self.lend, self.attrs = task, lend, attrs
        self.end_ns = None
        self._events = self._device_ms = None

    def __enter__(self):
        rec = self._rec
        self._session = rec.session
        self.id = next(rec._ids)
        stack = rec._stack()
        self.parent = stack[-1] if stack else rec._lender()
        if self.task is None and self.parent is not None:
            self.task = self.parent.task
        self.thread = threading.get_native_id()
        stack.append(self)
        if self.lend:
            rec._lenders.append(self)
        self._range = _P.record_function(self.name)
        self._range.__enter__()
        if self.device and torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self._events is not None:
            self._events[1].record()
        self._range.__exit__(None, None, None)
        self._range = None
        rec = self._rec
        rec._stack().pop()
        if self.lend:
            rec._lenders.remove(self)
        with rec._lock:
            self._session.add(self)
        return False

    def set(self, **attrs):
        """Add attributes to the open span (known only inside it)."""
        self.attrs.update(attrs)

    @property
    def ms(self) -> float:
        """Host milliseconds from start to end."""
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds between the span's CUDA events (its host time where
        it ran without CUDA); None for a span without ``device=True`` or
        whose events the device has not reached."""
        if not self.device:
            return None
        if self._events is None:
            return self.ms
        if self._device_ms is None:
            try:
                self._device_ms = self._events[0].elapsed_time(
                    self._events[1])
            except RuntimeError:            # not reached yet
                return None
        return self._device_ms

    def enclosing(self, name: str) -> Optional["Span"]:
        """The innermost span of this name that encloses this one."""
        p = self.parent
        while p is not None and p.name != name:
            p = p.parent
        return p

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, task={self.task!r}, "
                f"ms={self.ms if self.end_ns else None})")


class _Session:
    """What one stretch of tracing recorded."""

    def __init__(self, limit: int):
        self.limit = limit
        self.start_ns, self.end_ns = time.time_ns(), None
        self.spans: List[Span] = []
        self.dropped = 0
        self.counters: Dict[str, int] = defaultdict(int)

    def add(self, span: Span):
        if len(self.spans) < self.limit:
            self.spans.append(span)
        else:
            self.dropped += 1


@dataclass
class Snapshot:
    """A session's closed spans, in the order they closed, and its
    counters.  ``end_ns`` is None while the session records."""
    start_ns: int = 0
    end_ns: Optional[int] = None
    spans: List[Span] = field(default_factory=list)
    dropped: int = 0
    counters: Dict[str, int] = field(default_factory=dict)

    def named(self, *names: str) -> List[Span]:
        return [s for s in self.spans if s.name in names]


class Recorder:
    """The process's spans and counters (the module's functions use one
    instance); see the module's docstring."""

    def __init__(self, limit: int = LIMIT):
        self.on = False
        self.limit = limit
        self.session: Optional[_Session] = None
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._lenders: List[Span] = []
        self._by_profiler = self._by_operator = False

    # ------------------------------ record ------------------------------ #
    def span(self, name: str, *, device: bool = False,
             task: Optional[str] = None, lend: bool = False, **attrs):
        """A context manager that times the region it encloses (see the
        module's docstring); ``task`` names the task the region runs,
        ``lend`` offers the span as the parent of spans on autograd's
        threads."""
        if not self.on or torch.compiler.is_compiling():
            return _OFF
        return Span(self, name, device, task, lend, attrs)

    def count(self, name: str, n: int = 1):
        """Add ``n`` to the session's counter ``name``."""
        if not self.on:
            return
        with self._lock:
            self.session.counters[name] += n

    # ------------------------------ switch ------------------------------ #
    def enable(self):
        """Trace without a profiler, until :meth:`disable`."""
        self._switch(operator=True)

    def disable(self):
        self._switch(operator=False)

    def _switch(self, *, profiler=None, operator=None):
        with self._lock:
            if profiler is not None:
                self._by_profiler = profiler
            if operator is not None:
                self._by_operator = operator
            on = self._by_profiler or self._by_operator
            if on and not self.on:
                self.session = _Session(self.limit)
            elif self.on and not on:
                self.session.end_ns = time.time_ns()
            self.on = on

    # ------------------------------- read ------------------------------- #
    def snapshot(self) -> Snapshot:
        """The current session's record, or the last one's once it ended.
        Call it after synchronizing the device, for ``device_ms``."""
        with self._lock:
            s = self.session
            if s is None:
                return Snapshot()
            return Snapshot(s.start_ns, s.end_ns, list(s.spans), s.dropped,
                            dict(s.counters))

    # ----------------------------- internals ---------------------------- #
    def _stack(self) -> List[Span]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _lender(self) -> Optional[Span]:
        """The span a thread with no open span of its own takes as its
        parent: inside a backward, the lender if it is the only one open."""
        lenders = self._lenders[:]          # one read: others open, close
        if (len(lenders) == 1 and _graph_task is not None
                and _graph_task() != -1):
            return lenders[0]
        return None


def _follow_profiler(rec: Recorder):
    """Switch ``rec`` on and off with torch's profilers, which call these
    two functions of ``torch.autograd.profiler`` as they start and stop
    recording (and set its ``_is_profiler_enabled``)."""
    start, stop = _P._run_on_profiler_start, _P._run_on_profiler_stop

    def run_on_profiler_start():
        start()
        rec._switch(profiler=True)

    def run_on_profiler_stop():
        stop()
        rec._switch(profiler=False)

    _P._run_on_profiler_start = run_on_profiler_start
    _P._run_on_profiler_stop = run_on_profiler_stop
    if _P._is_profiler_enabled:
        rec._switch(profiler=True)


RECORDER = Recorder()
_follow_profiler(RECORDER)

span = RECORDER.span
count = RECORDER.count
enable = RECORDER.enable
disable = RECORDER.disable
snapshot = RECORDER.snapshot
