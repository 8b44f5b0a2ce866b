"""The concurrency analyzers, tested on seeded defects.

Each fixture module below contains exactly one known bug class; the
corresponding rule code must fire on it and must NOT fire on the clean
twin.  This is the analyzer's own regression suite — if a refactor of
the AST walkers stops catching the seeded deadlock, this file fails
before the real runtime quietly loses its safety net.

The watchdog tests drive the recording machinery directly with wrapped
locks (no global install), plus one install()/uninstall() round-trip
exercising the allocation-site filter and the TaskRecord validation
hook.
"""
import textwrap
import threading
import time

import pytest

from repro_torch.analysis import apply_baseline, load_baseline
from repro_torch.analysis.events import (analyze_events, analyze_state_machine,
                                         extract_registry)
from repro_torch.analysis.locks import analyze_lock_discipline
from repro_torch.analysis.watchdog import (LockWatchdog, _WrappedCondition,
                                           _WrappedLock, check_snapshot, install,
                                           uninstall)


def _src(text):
    return textwrap.dedent(text)


def _codes(findings):
    return sorted(f.code for f in findings)


# ---------------------------- lock discipline --------------------------- #

LOCK_CYCLE = _src("""
    import threading

    class S:
        def __init__(self):
            self.a = threading.Lock()
            self.b = threading.Lock()

        def fwd(self):
            with self.a:
                with self.b:
                    pass

        def rev(self):
            with self.b:
                with self.a:
                    pass
""")

LOCK_CYCLE_CROSS_METHOD = _src("""
    import threading

    class S:
        def __init__(self):
            self.a = threading.Lock()
            self.b = threading.Lock()

        def fwd(self):
            with self.a:
                self._inner()

        def _inner(self):
            with self.b:
                pass

        def rev(self):
            with self.b:
                with self.a:
                    pass
""")

SELF_DEADLOCK = _src("""
    import threading

    class S:
        def __init__(self):
            self.a = threading.Lock()

        def oops(self):
            with self.a:
                with self.a:
                    pass
""")

BLOCKING_PICKLE = _src("""
    import pickle
    import threading

    class S:
        def __init__(self):
            self.lk = threading.Lock()

        def save(self, obj, fh):
            with self.lk:
                data = pickle.dumps(obj)
                fh.write(data)
""")

UNGUARDED_WAIT = _src("""
    import threading

    class S:
        def __init__(self):
            self.cv = threading.Condition()
            self.ready = False

        def bad(self):
            with self.cv:
                self.cv.wait(1.0)

        def good(self):
            with self.cv:
                while not self.ready:
                    self.cv.wait(1.0)

        def also_good(self):
            with self.cv:
                self.cv.wait_for(lambda: self.ready, 1.0)
""")

CLEAN_LOCKS = _src("""
    import pickle
    import threading

    class S:
        def __init__(self):
            self.a = threading.Lock()
            self.b = threading.Lock()

        def fwd(self):
            with self.a:
                with self.b:
                    pass

        def also_fwd(self):
            with self.a:
                with self.b:
                    pass

        def save(self, obj, fh):
            with self.a:
                obj = dict(obj)
            data = pickle.dumps(obj)
            fh.write(data)
""")


def test_lock_cycle_same_method_rpx001():
    findings, graph = analyze_lock_discipline({"fix/cycle.py": LOCK_CYCLE})
    assert "RPX001" in _codes(findings)
    cyc = [f for f in findings if f.code == "RPX001"]
    assert any("cycle" in f.message for f in cyc)


def test_lock_cycle_through_self_call_rpx001():
    findings, _ = analyze_lock_discipline(
        {"fix/xcycle.py": LOCK_CYCLE_CROSS_METHOD})
    assert "RPX001" in _codes(findings)


def test_nonreentrant_reacquire_rpx001():
    findings, _ = analyze_lock_discipline({"fix/selfdl.py": SELF_DEADLOCK})
    sd = [f for f in findings if f.code == "RPX001"]
    assert sd and any("re-acquire" in f.message or "self" in f.message
                      for f in sd)


def test_blocking_pickle_under_lock_rpx002():
    findings, _ = analyze_lock_discipline({"fix/pkl.py": BLOCKING_PICKLE})
    hits = [f for f in findings if f.code == "RPX002"]
    # both pickle.dumps and fh.write happen under the lock
    assert len(hits) == 2
    assert all("lk" in f.message for f in hits)


def test_unguarded_wait_rpx003_and_clean_waits_pass():
    findings, _ = analyze_lock_discipline({"fix/wait.py": UNGUARDED_WAIT})
    hits = [f for f in findings if f.code == "RPX003"]
    assert len(hits) == 1                  # only S.bad; good/also_good clean
    assert "bad" in hits[0].key


def test_clean_module_has_no_lock_findings():
    findings, graph = analyze_lock_discipline({"fix/clean.py": CLEAN_LOCKS})
    assert findings == []
    # the consistent a->b order is still recorded in the graph
    assert any(e.src[1] == "a" and e.dst[1] == "b" for e in graph.edges)


def test_syntax_error_is_reported_not_swallowed():
    findings, _ = analyze_lock_discipline({"fix/broken.py": "def f(:\n"})
    assert _codes(findings) == ["RPX000"]


# ---------------------------- event protocol ---------------------------- #

REGISTRY = _src("""
    class EVENTS:
        PING = "PING"
        PONG = "PONG"
""")

EMIT_ONLY = _src("""
    def emit(store):
        store.record_event("PING", n=1)
""")

CONSUME_ONLY = _src("""
    def replay(events):
        return [e for e in events if e["event"] == "PONG"]
""")

UNDECLARED = _src("""
    def emit(store):
        store.record_event("ZING", n=1)

    def replay(events):
        return [e for e in events if e["event"] == "ZING"]
""")

CLEAN_PAIR = _src("""
    def emit(store):
        store.record_event("PING", n=1)

    def replay(events):
        return [e for e in events if e["event"] == "PING"]
""")


def test_emitted_never_consumed_rpx004():
    f = analyze_events({"reg.py": REGISTRY, "emit.py": EMIT_ONLY})
    assert "RPX004:PING" in {x.key for x in f}


def test_consumed_never_emitted_rpx005():
    f = analyze_events({"reg.py": REGISTRY, "cons.py": CONSUME_ONLY})
    assert "RPX005:PONG" in {x.key for x in f}


def test_undeclared_event_name_rpx006():
    f = analyze_events({"reg.py": REGISTRY, "bad.py": UNDECLARED})
    assert "RPX006:ZING" in {x.key for x in f}


def test_missing_registry_rpx006():
    f = analyze_events({"emit.py": EMIT_ONLY})
    assert "RPX006:<no-registry>" in {x.key for x in f}


def test_clean_event_pair_passes():
    f = analyze_events({"reg.py": REGISTRY, "ok.py": CLEAN_PAIR})
    assert f == []


def test_events_attr_references_resolve_through_registry():
    emit = _src("""
        from mod import EVENTS

        def emit(store):
            store.record_event(EVENTS.PING, n=1)

        def replay(events):
            return [e for e in events if e["event"] == EVENTS.PING]
    """)
    assert extract_registry({"reg.py": REGISTRY}) == {"PING": "PING",
                                                      "PONG": "PONG"}
    f = analyze_events({"reg.py": REGISTRY, "emit.py": emit})
    assert f == []


# ---------------------------- state machine ----------------------------- #

MACHINE = _src("""
    class TaskState:
        NEW = "NEW"
        DONE = "DONE"
        LOST = "LOST"

    STATE_MACHINE = {
        TaskState.NEW: (TaskState.DONE,),
        TaskState.DONE: (),
        TaskState.LOST: (),
    }
""")


def test_transition_without_inbound_edge_rpx007():
    use = _src("""
        def f(task):
            task.transition(TaskState.LOST)
    """)
    f = analyze_state_machine({"m.py": MACHINE, "u.py": use})
    assert any(x.key == "RPX007:u:f:LOST" for x in f)


def test_declared_transition_passes():
    use = _src("""
        def f(task):
            task.transition(TaskState.DONE)
    """)
    assert analyze_state_machine({"m.py": MACHINE, "u.py": use}) == []


def test_machine_member_drift_rpx007():
    bad = MACHINE.replace("    TaskState.LOST: (),\n", "")
    assert bad != MACHINE
    f = analyze_state_machine({"m.py": bad})
    assert any(x.key == "RPX007:machine:LOST" for x in f)


def test_missing_machine_rpx007():
    lone = _src("""
        class TaskState:
            NEW = "NEW"
    """)
    f = analyze_state_machine({"m.py": lone})
    assert any(x.key == "RPX007:machine:<missing>" for x in f)


# ------------------------------- baseline ------------------------------- #

def test_baseline_suppresses_and_reports_stale(tmp_path):
    bl = tmp_path / "baseline.txt"
    bl.write_text(
        "# comment line\n"
        "RPX002:pkl:S.save:pickle.dumps  # leaf lock, documented\n"
        "RPX001:gone:X.y:stale  # fixed long ago\n")
    entries = load_baseline(bl)
    assert entries["RPX002:pkl:S.save:pickle.dumps"] == \
        "leaf lock, documented"
    findings, _ = analyze_lock_discipline({"fix/pkl.py": BLOCKING_PICKLE})
    pkl = [f for f in findings if f.key.endswith("pickle.dumps")]
    new, suppressed, stale = apply_baseline(pkl, entries)
    assert new == []
    assert suppressed == ["RPX002:pkl:S.save:pickle.dumps"]
    assert stale == ["RPX001:gone:X.y:stale"]


def test_repo_gate_is_green():
    """The committed baseline covers the live tree: the same entry point
    CI runs must pass here."""
    from repro_torch.analysis.__main__ import main
    assert main([]) == 0


# ------------------------------- watchdog ------------------------------- #

def _wrapped_pair(wd):
    a = _WrappedLock(threading.Lock(), "mod.py:10", wd)
    b = _WrappedLock(threading.Lock(), "mod.py:20", wd)
    return a, b


def test_watchdog_consistent_order_is_clean():
    wd = LockWatchdog()
    a, b = _wrapped_pair(wd)
    for _ in range(3):
        with a:
            with b:
                pass
    snap = wd.snapshot()
    assert snap["cycles"] == []
    assert snap["edge_count"] == 1
    assert wd.check() == []


def test_watchdog_opposite_order_across_threads_rpx008():
    wd = LockWatchdog()
    a, b = _wrapped_pair(wd)
    # interleave for real: two threads, barriers between the conflicting
    # critical sections so both orders are actually recorded
    def fwd():
        with a:
            with b:
                pass

    def rev():
        with b:
            with a:
                pass

    t1 = threading.Thread(target=fwd)
    t1.start(); t1.join()
    t2 = threading.Thread(target=rev)
    t2.start(); t2.join()
    findings = wd.check()
    assert [f.code for f in findings] == ["RPX008"]
    assert "mod.py:10" in findings[0].message


def test_watchdog_rlock_reentry_is_not_an_edge():
    wd = LockWatchdog()
    r = _WrappedLock(threading.RLock(), "mod.py:30", wd)
    with r:
        with r:
            pass
    snap = wd.snapshot()
    assert snap["edge_count"] == 0
    assert snap["cycles"] == []


def test_watchdog_hold_ceiling_rpx009():
    wd = LockWatchdog()
    a, _ = _wrapped_pair(wd)
    with a:
        time.sleep(0.05)
    findings = wd.check(hold_ceiling_s=0.01)
    assert [f.code for f in findings] == ["RPX009"]
    assert wd.check(hold_ceiling_s=5.0) == []


def test_watchdog_condition_wait_excluded_from_hold():
    wd = LockWatchdog()
    cv = _WrappedCondition(threading.Condition(), "mod.py:40", wd)
    with cv:
        cv.wait(0.05)                     # parked: lock genuinely free
    snap = wd.snapshot()
    assert snap["max_hold_ms"]["mod.py:40"] < 40


def test_watchdog_transition_violation_rpx007():
    wd = LockWatchdog()
    wd.on_transition("DONE", "RUNNING", "task.000001")
    findings = wd.check()
    assert [f.code for f in findings] == ["RPX007"]
    assert "DONE -> RUNNING" in findings[0].message


def test_check_snapshot_round_trips_saved_report():
    snap = {
        "cycles": [["x.py:1", "y.py:2"]],
        "max_hold_ms": {"x.py:1": 5000.0},
        "transition_violations": [
            {"uid": "t", "from": "DONE", "to": "NEW"}],
    }
    codes = sorted(f.code for f in check_snapshot(snap, hold_ceiling_s=2.0))
    assert codes == ["RPX007", "RPX008", "RPX009"]


def test_install_filters_by_allocation_site():
    """install() wraps locks allocated from repro_torch source files only;
    stdlib-internal allocations (threading.Event) keep real primitives,
    and an illegal TaskRecord transition is recorded."""
    from repro_torch.analysis import watchdog as wdmod
    from repro_torch.core.futures import TaskState
    from repro_torch.core.translator import translate
    if wdmod.active() is not None:
        pytest.skip("watchdog already installed session-wide "
                    "(REPRO_LOCK_WATCHDOG=1); install() path covered "
                    "by the instrumented run itself")
    wd = install()
    try:
        fake = compile("import threading\nlk = threading.Lock()\n",
                       "/x/repro_torch/core/fake.py", "exec")
        ns = {}
        exec(fake, ns)
        assert isinstance(ns["lk"], _WrappedLock)
        assert ns["lk"]._site == "core/fake.py:2"
        with ns["lk"]:
            pass
        assert wd.acquisitions == {"core/fake.py:2": 1}
        ev = threading.Event()             # allocated inside threading.py
        ev.set(); ev.clear()               # must behave like a real Event
        assert not isinstance(ev._cond, _WrappedCondition)

        t = translate(lambda: 1, (), {})
        t.transition(TaskState.DONE)
        t.transition(TaskState.RUNNING)    # illegal: DONE is terminal
        assert any(v["from"] == "DONE" and v["to"] == "RUNNING"
                   for v in wd.transition_violations)
    finally:
        uninstall()
    assert threading.Lock is not ns["lk"].__class__
    assert not isinstance(threading.Lock(), _WrappedLock)
