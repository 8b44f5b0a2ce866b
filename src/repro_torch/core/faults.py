"""Chaos-injection harness — seeded, deterministic fault schedules.

The runtime's failure domains (docs/resilience.md) are exercised by a
``FaultInjector`` driving four injection kinds against a live PilotPool:

  pilot-crash   — the victim pilot's scheduler and monitor loops die
                  silently (``Agent.inject_crash``): heartbeats go stale
                  and the pool's health monitor must declare the pilot
                  LOST and recover its tasks.
  worker-kill   — SIGKILL one live worker process of a proc-transport
                  pilot: the in-flight task fails with ``WorkerDied`` and
                  the retry classifier / poison quarantine take over.
                  No-op (logged) on inproc pilots.
  task-hang     — SIGSTOP a worker process for a duration, then SIGCONT:
                  the task genuinely hangs (no error, no EOF), so
                  straggler replicas and shutdown's stranded-task report
                  are what notice it.  No-op (logged) on inproc pilots.
  slot-failure  — ``Agent.inject_slot_failure`` on random slots: running
                  victims fail mid-flight with ``SlotFailure``.

Schedules are explicit ``at_s`` offsets from ``start()``; victim choice
(when not pinned) and slot choice come from a seeded ``random.Random``,
so a chaos storm replays identically for a given seed.  One timer thread
walks the sorted schedule with event waits — nothing here polls, and
nothing here touches the task path of healthy pilots.

The two error types the injector (and the lost-pilot recovery) surface —
``PilotLost`` and ``SlotFailure`` — live here so the agent's retry
classifier can treat them as *infrastructure* failures (prefer a
different pilot) without import cycles.
"""
from __future__ import annotations

import os
import random
import signal
import threading
import time
from typing import Callable, List, Optional


class PilotLost(RuntimeError):
    """The pilot a task was queued/running on was declared LOST by the
    pool's health supervision (missed heartbeats or injected crash)."""


class SlotFailure(RuntimeError):
    """A slot the task was running on failed (injected node-failure
    analog); classified as an infrastructure error by the retry path."""


class FaultInjector:
    """Deterministic chaos schedule against a PilotPool.

    >>> fi = FaultInjector(pool, seed=7)
    >>> fi.add_pilot_crash(at_s=0.5)             # random victim
    >>> fi.add_worker_kill(at_s=0.2, pilot=p1)   # pinned victim
    >>> fi.add_slot_failure(at_s=0.8, n_slots=2)
    >>> fi.start(); ...workload...; fi.stop()

    ``events`` records every injection actually performed (kind, time,
    victim) — benchmarks and tests assert against it."""

    def __init__(self, pool, seed: int = 0):
        self.pool = pool
        self.rng = random.Random(seed)
        self.events: List[dict] = []
        self._schedule: List[tuple] = []   # (at_s, seq, fn, label)
        self._seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t0: Optional[float] = None

    # ------------------------------ schedule --------------------------- #
    def _add(self, at_s: float, fn: Callable, label: str):
        self._schedule.append((at_s, self._seq, fn, label))
        self._seq += 1
        return self

    def add_pilot_crash(self, at_s: float, pilot=None):
        return self._add(at_s, lambda: self._pilot_crash(pilot),
                         "pilot-crash")

    def add_worker_kill(self, at_s: float, pilot=None):
        return self._add(at_s, lambda: self._worker_kill(pilot),
                         "worker-kill")

    def add_task_hang(self, at_s: float, duration_s: float = 0.5,
                      pilot=None):
        return self._add(at_s, lambda: self._task_hang(pilot, duration_s),
                         "task-hang")

    def add_slot_failure(self, at_s: float, pilot=None, n_slots: int = 1):
        return self._add(at_s, lambda: self._slot_failure(pilot, n_slots),
                         "slot-failure")

    def storm(self, duration_s: float, pilot_crashes: int = 1,
              worker_kills: int = 0, slot_failures: int = 0,
              task_hangs: int = 0, warmup_s: float = 0.1):
        """Spread a mixed fault load over ``duration_s`` (times drawn
        from the seeded rng, so the storm is reproducible)."""
        def times(n):
            return sorted(warmup_s + self.rng.random()
                          * max(0.0, duration_s - warmup_s)
                          for _ in range(n))
        for t in times(pilot_crashes):
            self.add_pilot_crash(t)
        for t in times(worker_kills):
            self.add_worker_kill(t)
        for t in times(slot_failures):
            self.add_slot_failure(t)
        for t in times(task_hangs):
            self.add_task_hang(t)
        return self

    # ------------------------------- driver ----------------------------- #
    def start(self) -> "FaultInjector":
        self._t0 = time.monotonic()
        self._schedule.sort(key=lambda e: (e[0], e[1]))
        self._thread = threading.Thread(target=self._drive, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _drive(self):
        for at_s, _, fn, label in self._schedule:
            delay = self._t0 + at_s - time.monotonic()
            if delay > 0 and self._stop.wait(delay):
                return
            if self._stop.is_set():
                return
            try:
                fn()
            except Exception as e:   # noqa: BLE001 — chaos must not crash
                self._log(label, error=repr(e))   # the injector itself

    def _log(self, kind: str, **fields):
        self.events.append({"kind": kind,
                            "t": time.monotonic() - (self._t0 or 0.0),
                            **fields})

    # ----------------------------- injections --------------------------- #
    def _pick_pilot(self, pilot, need_proc: bool = False):
        if pilot is not None:
            return pilot
        cands = [p for p in self.pool.active()
                 if not p.draining and not p.agent.crashed]
        if need_proc:
            cands = [p for p in cands
                     if hasattr(p.agent.transport, "worker_pids")]
        return self.rng.choice(cands) if cands else None

    def _pilot_crash(self, pilot):
        p = self._pick_pilot(pilot)
        if p is None:
            self._log("pilot-crash", skipped="no eligible pilot")
            return
        p.agent.inject_crash()
        self._log("pilot-crash", pilot=p.uid)

    def _worker_pid(self, p) -> Optional[int]:
        pids = getattr(p.agent.transport, "worker_pids", lambda: [])()
        return self.rng.choice(sorted(pids)) if pids else None

    def _worker_kill(self, pilot):
        p = self._pick_pilot(pilot, need_proc=True)
        pid = self._worker_pid(p) if p is not None else None
        if pid is None:
            self._log("worker-kill", skipped="no live proc worker")
            return
        try:
            os.kill(pid, signal.SIGKILL)
            self._log("worker-kill", pilot=p.uid, pid=pid)
        except ProcessLookupError:
            self._log("worker-kill", skipped=f"pid {pid} already gone")

    def _task_hang(self, pilot, duration_s: float):
        p = self._pick_pilot(pilot, need_proc=True)
        pid = self._worker_pid(p) if p is not None else None
        if pid is None:
            self._log("task-hang", skipped="no live proc worker")
            return
        try:
            os.kill(pid, signal.SIGSTOP)
        except ProcessLookupError:
            self._log("task-hang", skipped=f"pid {pid} already gone")
            return
        self._log("task-hang", pilot=p.uid, pid=pid, duration_s=duration_s)

        def resume():
            if not self._stop.wait(duration_s):
                pass
            try:
                os.kill(pid, signal.SIGCONT)
            except ProcessLookupError:
                pass
        threading.Thread(target=resume, daemon=True).start()

    def _slot_failure(self, pilot, n_slots: int):
        p = self._pick_pilot(pilot)
        if p is None:
            self._log("slot-failure", skipped="no eligible pilot")
            return
        cap = p.scheduler.capacity
        slots = self.rng.sample(range(cap), min(n_slots, cap))
        victims = p.agent.inject_slot_failure(slots)
        self._log("slot-failure", pilot=p.uid, slots=slots,
                  victims=list(victims))
