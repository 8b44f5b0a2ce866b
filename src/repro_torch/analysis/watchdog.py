"""Runtime lock-order watchdog (RPX007-RPX009) — opt-in instrumentation.

``install()`` replaces ``threading.Lock/RLock/Condition`` with factories
that wrap locks *allocated from repro_torch source files* (everything else —
stdlib internals, futures, third-party — gets the real thing, so the
interpreter's own locking is never perturbed).  Each wrapped lock is
identified by its allocation site (``module.py:lineno``), so every
instance allocated by the same constructor line is one node in the order
graph — exactly the granularity the static analyzer reasons at.

While installed, the watchdog records per-thread acquisition stacks:

  * every acquisition made while other instrumented locks are held adds
    ordered edges (held → new) to a global order graph;
  * hold times are tracked per site (``Condition.wait`` windows are
    excluded — the lock is genuinely released while waiting);
  * ``TaskRecord.transition`` is validated against the declared
    STATE_MACHINE (violations recorded, reported as RPX007).

``check()`` turns the recorded graph into findings: a cycle is RPX008
(two threads really interleaved those locks in opposite orders during
the run — a latent deadlock the static pass may not see across object
boundaries), and a hold beyond the wall-time ceiling is RPX009.

Activation:  set ``REPRO_LOCK_WATCHDOG=1`` before importing
``repro_torch.core`` (the package installs the watchdog on import); set
``REPRO_LOCK_WATCHDOG_OUT=path.json`` to write the order-graph report at
interpreter exit.

One watchdog per process.  The JAX reference package ships a watchdog of
its own behind the same switch, and a process that imports both (the
parity tests) must not have both patch ``threading``: this one installs
only over the real primitives, and yields (``maybe_install_from_env``
returns None, ``install`` raises) when another watchdog has already
replaced them.
"""
from __future__ import annotations

import _thread
import atexit
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import Finding

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition


def _primitives_are_real() -> bool:
    """True when ``threading`` holds its own primitives (and ours are
    they): no other watchdog has replaced them."""
    return (_REAL_LOCK is _thread.allocate_lock
            and threading.Lock is _REAL_LOCK
            and threading.RLock is _REAL_RLOCK
            and threading.Condition is _REAL_CONDITION)

DEFAULT_HOLD_CEILING_S = 2.0


class LockWatchdog:
    """Global acquisition recorder shared by every instrumented lock."""

    def __init__(self):
        self._mu = _REAL_LOCK()                   # guards the maps below
        self._tls = threading.local()             # per-thread held stack
        self.edges: Dict[Tuple[str, str], int] = {}
        self.max_hold: Dict[str, float] = {}
        self.acquisitions: Dict[str, int] = {}
        self.threads: set = set()
        self.transition_violations: List[dict] = []

    # ------------------------ per-thread held stack --------------------- #
    def _stack(self) -> List[List]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def on_acquire(self, site: str):
        st = self._stack()
        t = time.monotonic()
        new_edges = []
        for held_site, _, depth in st:
            if held_site != site:
                new_edges.append((held_site, site))
        for entry in st:
            if entry[0] == site:                  # RLock re-entry
                entry[2] += 1
                return
        st.append([site, t, 1])
        with self._mu:
            self.threads.add(threading.get_ident())
            self.acquisitions[site] = self.acquisitions.get(site, 0) + 1
            for e in new_edges:
                self.edges[e] = self.edges.get(e, 0) + 1

    def on_release(self, site: str):
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i][0] == site:
                st[i][2] -= 1
                if st[i][2] == 0:
                    held_s = time.monotonic() - st[i][1]
                    del st[i]
                    with self._mu:
                        if held_s > self.max_hold.get(site, 0.0):
                            self.max_hold[site] = held_s
                return

    # Condition.wait: the underlying lock is released for the duration —
    # close the hold window on entry, open a fresh one on wakeup
    def on_wait_release(self, site: str):
        self.on_release(site)

    def on_wait_reacquire(self, site: str):
        self.on_acquire(site)

    def on_transition(self, frm: str, to: str, uid: str):
        with self._mu:
            if len(self.transition_violations) < 200:
                self.transition_violations.append(
                    {"uid": uid, "from": frm, "to": to})

    # ------------------------------ reporting --------------------------- #
    def _cycles(self) -> List[List[str]]:
        adj: Dict[str, set] = {}
        for (a, b) in self.edges:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: set = set()
        stack: List[str] = []
        out: List[List[str]] = []
        counter = [0]
        for root in sorted(adj):
            if root in index:
                continue
            work = [(root, iter(sorted(adj[root])))]
            index[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on_stack.add(root)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(sorted(adj[w]))))
                        advanced = True
                        break
                    elif w in on_stack:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    low[work[-1][0]] = min(low[work[-1][0]], low[node])
                if low[node] == index[node]:
                    scc = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        scc.append(w)
                        if w == node:
                            break
                    if len(scc) > 1:
                        out.append(sorted(scc))
        return out

    def snapshot(self) -> dict:
        with self._mu:
            edges = sorted(self.edges.items())
            max_hold = dict(self.max_hold)
            acq = dict(self.acquisitions)
            nthreads = len(self.threads)
            violations = list(self.transition_violations)
        return {
            "locks": len({s for e, _ in edges for s in e} | set(max_hold)),
            "edge_count": len(edges),
            "edges": [{"src": a, "dst": b, "count": n}
                      for (a, b), n in edges],
            "cycles": self._cycles(),
            "max_hold_ms": {s: round(v * 1e3, 3)
                            for s, v in sorted(max_hold.items())},
            "max_hold_ms_overall": round(
                max(max_hold.values(), default=0.0) * 1e3, 3),
            "acquisitions": acq,
            "threads": nthreads,
            "transition_violations": violations,
        }

    def check(self, hold_ceiling_s: float = DEFAULT_HOLD_CEILING_S,
              ) -> List[Finding]:
        return check_snapshot(self.snapshot(), hold_ceiling_s)

    def write_report(self, path: str):
        snap = self.snapshot()
        with open(path, "w") as fh:
            json.dump(snap, fh, indent=2)
        return snap


def check_snapshot(snap: dict,
                   hold_ceiling_s: float = DEFAULT_HOLD_CEILING_S,
                   ) -> List[Finding]:
    """Findings from a watchdog snapshot (live or a saved JSON report)."""
    findings: List[Finding] = []
    for cyc in snap.get("cycles", ()):
        findings.append(Finding(
            "RPX008", "<runtime>", 0,
            f"runtime lock-order cycle observed between "
            f"{{{', '.join(cyc)}}} — two threads acquired these locks in "
            f"conflicting orders",
            f"RPX008:{'->'.join(cyc)}"))
    for site, ms in sorted(snap.get("max_hold_ms", {}).items()):
        if ms > hold_ceiling_s * 1e3:
            findings.append(Finding(
                "RPX009", site, 0,
                f"lock allocated at {site} was held for {ms:.0f}ms "
                f"(> {hold_ceiling_s * 1e3:.0f}ms ceiling)",
                f"RPX009:{site}"))
    for v in snap.get("transition_violations", ())[:20]:
        findings.append(Finding(
            "RPX007", "<runtime>", 0,
            f"task {v['uid']} transitioned {v['from']} -> {v['to']}, "
            f"an edge STATE_MACHINE does not declare",
            f"RPX007:runtime:{v['from']}->{v['to']}"))
    return findings


# ----------------------------- lock wrappers ---------------------------- #

class _WrappedLock:
    """Instrumented Lock/RLock: records acquire/release on the global
    watchdog, proxies everything else to the real primitive."""

    def __init__(self, real, site: str, wd: LockWatchdog):
        self._real = real
        self._site = site
        self._wd = wd

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._real.acquire(blocking, timeout)
        if ok:
            self._wd.on_acquire(self._site)
        return ok

    def release(self):
        self._wd.on_release(self._site)
        self._real.release()

    def locked(self):
        return self._real.locked()

    def _is_owned(self):                          # Condition compatibility
        f = getattr(self._real, "_is_owned", None)
        if f is not None:
            return f()
        if self._real.acquire(False):
            self._real.release()
            return False
        return True

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<watchdog {self._real!r} @{self._site}>"


class _WrappedCondition:
    """Instrumented Condition: acquire/release tracked like a lock;
    ``wait``/``wait_for`` close the hold window while parked (the lock
    really is released) and reopen it on wakeup."""

    def __init__(self, real, site: str, wd: LockWatchdog):
        self._real = real
        self._site = site
        self._wd = wd

    def acquire(self, *a, **kw):
        ok = self._real.acquire(*a, **kw)
        if ok:
            self._wd.on_acquire(self._site)
        return ok

    def release(self):
        self._wd.on_release(self._site)
        self._real.release()

    def wait(self, timeout: Optional[float] = None):
        self._wd.on_wait_release(self._site)
        try:
            return self._real.wait(timeout)
        finally:
            self._wd.on_wait_reacquire(self._site)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        self._wd.on_wait_release(self._site)
        try:
            return self._real.wait_for(predicate, timeout)
        finally:
            self._wd.on_wait_reacquire(self._site)

    def notify(self, n: int = 1):
        self._real.notify(n)

    def notify_all(self):
        self._real.notify_all()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<watchdog {self._real!r} @{self._site}>"


# ------------------------------ installation ---------------------------- #

_installed: Optional[LockWatchdog] = None


def _alloc_site(depth: int = 2) -> Tuple[str, bool]:
    """(site id, instrument?) from the allocating frame.  Only locks whose
    *direct* allocator is a repro_torch source file (outside this
    analysis package) are wrapped: stdlib helpers
    that build locks internally (``threading.Event``, ``queue.Queue``,
    ``concurrent.futures``) must get real primitives — their fork/reset
    paths call ``__init__`` on them in ways a proxy cannot honor."""
    f = sys._getframe(depth)
    fn = f.f_code.co_filename
    norm = fn.replace(os.sep, "/")
    if "/repro_torch/" in norm and "/repro_torch/analysis/" not in norm:
        sub = norm.rsplit("/repro_torch/", 1)[-1]
        return f"{sub}:{f.f_lineno}", True
    return f"{os.path.basename(fn)}:{f.f_lineno}", False


def install(watchdog: Optional[LockWatchdog] = None) -> LockWatchdog:
    """Patch ``threading.Lock/RLock/Condition`` with instrumenting
    factories.  Idempotent; returns the active watchdog.  Raises when
    another watchdog has already replaced the primitives."""
    global _installed
    if _installed is not None:
        return _installed
    if not _primitives_are_real():
        raise RuntimeError("threading's lock primitives are already "
                           "replaced by another lock watchdog; one "
                           "watchdog per process")
    wd = watchdog or LockWatchdog()

    def make_lock():
        site, instr = _alloc_site()
        real = _REAL_LOCK()
        return _WrappedLock(real, site, wd) if instr else real

    def make_rlock():
        site, instr = _alloc_site()
        real = _REAL_RLOCK()
        return _WrappedLock(real, site, wd) if instr else real

    def make_condition(lock=None):
        site, instr = _alloc_site()
        inner = lock
        if isinstance(inner, (_WrappedLock,)):
            # the Condition tracks through its own wrapper; hand the
            # real primitive to the real Condition underneath
            inner = inner._real
        real = _REAL_CONDITION(inner) if inner is not None \
            else _REAL_CONDITION()
        return _WrappedCondition(real, site, wd) if instr else real

    threading.Lock = make_lock
    threading.RLock = make_rlock
    threading.Condition = make_condition
    _installed = wd

    # task-lifecycle validation rides the same opt-in switch
    try:
        from ..core import futures as _futures
        machine = {k.value: {t.value for t in v}
                   for k, v in getattr(_futures, "STATE_MACHINE",
                                       {}).items()}

        def _validate(frm, to, uid):
            if machine and to not in machine.get(frm, ()):
                wd.on_transition(frm, to, uid)
        _futures._validate_transition = _validate
    except Exception:                             # pragma: no cover
        pass
    return wd


def uninstall():
    """Restore the real primitives (the validation hook included).
    Already-created wrapped locks keep working — their real lock is
    inside — so this is safe mid-run."""
    global _installed
    if _installed is None:
        return                      # never installed (or yielded): the
                                    # primitives are not ours to restore
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    threading.Condition = _REAL_CONDITION
    try:
        from ..core import futures as _futures
        _futures._validate_transition = None
    except Exception:                             # pragma: no cover
        pass
    _installed = None


def active() -> Optional[LockWatchdog]:
    return _installed


def maybe_install_from_env() -> Optional[LockWatchdog]:
    """Called by ``repro_torch.core`` on import: install when
    ``REPRO_LOCK_WATCHDOG`` is set, unless another watchdog already holds
    the primitives; arrange the exit report when
    ``REPRO_LOCK_WATCHDOG_OUT`` names a file."""
    if not os.environ.get("REPRO_LOCK_WATCHDOG"):
        return None
    if _installed is None and not _primitives_are_real():
        return None
    wd = install()
    out = os.environ.get("REPRO_LOCK_WATCHDOG_OUT")
    if out:
        atexit.register(lambda: wd.write_report(out))
    return wd
