"""Event-driven multi-pilot runtime behaviour: PilotPool routing, the
condition-variable scheduler (no missed wakeups, no polling), persistent
worker pool, and prompt event-based shutdown."""
import threading
import time

import pytest
import torch

from repro_torch.core import (DataFlowKernel, PilotPool,
                              ResourceSpec, RPEXExecutor, TaskState, python_app,
                              spmd_app, translate)
from repro_torch.core import PilotDescription as _PilotDescription


def PilotDescription(*args, **kw):
    """The suite's pilot descriptions on the CPU, asked for explicitly: a
    description without devices means every CUDA device, and raises
    without a card."""
    kw.setdefault("devices", [torch.device("cpu")])
    return _PilotDescription(*args, **kw)


def _hetero_rpex():
    return RPEXExecutor([
        PilotDescription(n_slots=4, kinds=("python", "bash", "cpu"),
                         name="cpu"),
        PilotDescription(n_slots=4, kinds=("spmd", "device"), name="dev"),
    ])


# ------------------------------ routing -------------------------------- #

def test_pool_routes_kinds_to_different_pilots():
    """An RPEXExecutor backed by 2 pilots sends kind="python" and
    kind="spmd" tasks to different, kind-compatible pilots."""
    rpex = _hetero_rpex()
    try:
        @python_app
        def py_task(x):
            return x + 1

        @spmd_app(slots=2, jit=False)
        def dev_task(mesh):
            return "spmd-ok"

        with DataFlowKernel(executors={"rpex": rpex}):
            fp = py_task(1)
            fd = dev_task()
            assert fp.result() == 2
            assert fd.result() == "spmd-ok"

        cpu_pilot = rpex.pool.pilots[0]
        dev_pilot = rpex.pool.pilots[1]
        assert fp.task.kind == "python" and fd.task.kind == "spmd"
        assert fp.task.pilot_uid == cpu_pilot.uid
        assert fd.task.pilot_uid == dev_pilot.uid
        assert fp.task.pilot_uid != fd.task.pilot_uid
        assert fp.task.res_kind == "cpu" and fd.task.res_kind == "device"
    finally:
        rpex.shutdown()


def test_pool_rejects_unroutable_kind():
    pool = PilotPool([PilotDescription(n_slots=2, kinds=("spmd",))])
    try:
        t = translate(lambda: None, (), {})       # kind="python"
        with pytest.raises(RuntimeError, match="no pilot accepts"):
            pool.route(t)
    finally:
        pool.close()


def test_unroutable_task_fails_future_not_thread():
    """A task no pilot accepts resolves its future with the routing error —
    in stream and in bulk mode (where routing runs in the flush timer
    thread) — and never hangs the rest of the batch."""
    rpex = RPEXExecutor(PilotDescription(n_slots=2, kinds=("spmd",)))
    try:
        @python_app
        def nope():
            return 1

        @spmd_app(slots=1, jit=False)
        def ok(mesh):
            return "ok"

        with DataFlowKernel(executors={"rpex": rpex}, bulk=True) as dfk:
            f_bad = nope()
            f_ok = ok()
            dfk.flush()
            assert f_ok.result(timeout=10) == "ok"   # batch not dropped
            with pytest.raises(RuntimeError, match="no pilot accepts"):
                f_bad.result(timeout=10)
        with DataFlowKernel(executors={"rpex": rpex}):
            with pytest.raises(RuntimeError, match="no pilot accepts"):
                nope().result(timeout=10)            # stream mode too
        assert rpex.tmgr.wait(timeout=5)             # nothing left hanging
    finally:
        rpex.shutdown()


def test_bash_app_routes_to_bash_pilot():
    """@bash_app tasks execute as kind="python" but route on their
    pre-translation app kind, so kinds=("bash",) pilots receive them."""
    from repro_torch.core import bash_app

    rpex = RPEXExecutor([
        PilotDescription(n_slots=2, kinds=("bash",), name="login"),
        PilotDescription(n_slots=2, kinds=("spmd",), name="dev"),
    ])
    try:
        @bash_app
        def say():
            return "echo routed"

        with DataFlowKernel(executors={"rpex": rpex}):
            f = say()
            assert f.result(timeout=10).strip() == "routed"
        assert f.task.pilot_uid == rpex.pool.pilots[0].uid
        assert f.task.app_kind == "bash" and f.task.kind == "python"
    finally:
        rpex.shutdown()


def test_least_loaded_binding_spreads_bulk():
    """Two identical pilots: a bulk batch is spread across both."""
    rpex = RPEXExecutor([PilotDescription(n_slots=2, name="a"),
                         PilotDescription(n_slots=2, name="b")])
    try:
        gate = threading.Event()

        @python_app
        def held(i):
            gate.wait(10)
            return i

        with DataFlowKernel(executors={"rpex": rpex}, bulk=True) as dfk:
            futs = [held(i) for i in range(16)]
            dfk.flush()
            time.sleep(0.3)              # let routing/scheduling settle
            gate.set()
            assert sorted(f.result(timeout=30) for f in futs) == list(range(16))
        pilots_used = {f.task.pilot_uid for f in futs}
        assert len(pilots_used) == 2, "bulk batch never left the first pilot"
    finally:
        rpex.shutdown()


def test_journal_replay_across_pool(tmp_path):
    """Workflow keys recorded on a routed pilot replay through the
    executor-level completed_result lookup."""
    @python_app
    def work(x):
        return x * 7

    calls = []

    @python_app
    def count(x):
        calls.append(x)
        return x

    j1 = str(tmp_path / "cpu.jsonl")
    descs = lambda: [PilotDescription(n_slots=2, kinds=("python", "bash"),
                                      journal=j1, name="cpu"),
                     PilotDescription(n_slots=2, kinds=("spmd",), name="dev")]
    r1 = RPEXExecutor(descs())
    with DataFlowKernel(executors={"rpex": r1}, run_id="rr"):
        assert work(6).result() == 42
    r1.shutdown()
    r2 = RPEXExecutor(descs())
    with DataFlowKernel(executors={"rpex": r2}, run_id="rr"):
        assert work(6).result() == 42     # resolved from journal replay
    r2.shutdown()
    found, result = r2.completed_result("rr/work:0")
    assert found and result == 42


# ----------------------- condition-variable loop ------------------------ #

def test_release_wakes_blocked_scheduler():
    """A task blocked on allocation is scheduled by the release() wakeup —
    no missed-wakeup deadlock, no polling latency."""
    rpex = RPEXExecutor(PilotDescription(n_slots=2))
    try:
        gate = threading.Event()

        @spmd_app(slots=2, jit=False)
        def hog(mesh):
            gate.wait(10)
            return "hog"

        @spmd_app(slots=2, jit=False)
        def blocked(mesh):
            return "ran"

        with DataFlowKernel(executors={"rpex": rpex}):
            fh = hog()
            time.sleep(0.2)               # hog owns every slot
            fb = blocked()
            time.sleep(0.2)               # blocked() cannot be placed yet
            assert not fb.done()
            t0 = time.monotonic()
            gate.set()
            assert fb.result(timeout=10) == "ran"
            dt = time.monotonic() - t0
            assert fh.result(timeout=10) == "hog"
        # generous bound: the wakeup is event-driven, not a poll tick
        assert dt < 2.0
    finally:
        rpex.shutdown()


def test_stream_submission_storm_no_missed_wakeup():
    """Concurrent stream submissions from several threads all complete —
    a lost cv notification would deadlock this test."""
    rpex = RPEXExecutor(PilotDescription(n_slots=4))
    try:
        @python_app
        def inc(x):
            return x + 1

        results = []
        rlock = threading.Lock()

        def feeder(dfk, base):
            for i in range(40):
                f = dfk.submit(inc.__wrapped_app__, (base + i,))
                with rlock:
                    results.append(f)

        with DataFlowKernel(executors={"rpex": rpex}) as dfk:
            threads = [threading.Thread(target=feeder, args=(dfk, k * 100))
                       for k in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            got = sorted(f.result(timeout=30) for f in results)
        want = sorted(k * 100 + i + 1 for k in range(4) for i in range(40))
        assert got == want
    finally:
        rpex.shutdown()


def test_bulk_batch_runs_concurrently():
    """Tasks scheduled in one pass must execute in parallel: the worker
    pool grows to cover the whole batch, not one worker per pass."""
    rpex = RPEXExecutor(PilotDescription(n_slots=8))
    try:
        barrier = threading.Barrier(8, timeout=10)

        @python_app
        def rendezvous(i):
            barrier.wait()            # deadlocks unless all 8 run at once
            return i

        with DataFlowKernel(executors={"rpex": rpex}, bulk=True) as dfk:
            futs = [rendezvous(i) for i in range(8)]
            dfk.flush()
            assert sorted(f.result(timeout=15) for f in futs) == list(range(8))
    finally:
        rpex.shutdown()


def test_worker_pool_is_persistent():
    """Many more tasks than workers reuse the same pool threads instead of
    spawning one thread per task."""
    rpex = RPEXExecutor(PilotDescription(n_slots=4, max_workers=4))
    try:
        @python_app
        def noop(i):
            return i

        with DataFlowKernel(executors={"rpex": rpex}):
            futs = [noop(i) for i in range(100)]
            assert [f.result(timeout=30) for f in futs] == list(range(100))
        agent = rpex.pilot.agent
        assert agent.transport.n_threads <= 4
    finally:
        rpex.shutdown()


# ------------------------------ shutdown -------------------------------- #

def test_shutdown_returns_promptly_when_idle():
    rpex = RPEXExecutor(PilotDescription(n_slots=4))

    @python_app
    def one():
        return 1

    with DataFlowKernel(executors={"rpex": rpex}):
        assert one().result() == 1
    t0 = time.monotonic()
    rpex.pilot.agent.shutdown()           # idle: event wait returns at once
    assert time.monotonic() - t0 < 1.0
    rpex.shutdown()


def test_shutdown_waits_for_inflight_then_returns():
    rpex = RPEXExecutor(PilotDescription(n_slots=2))

    @python_app
    def slowish():
        time.sleep(0.4)
        return "done"

    with DataFlowKernel(executors={"rpex": rpex}):
        f = slowish()
        time.sleep(0.05)                  # ensure it is in flight
        t0 = time.monotonic()
        rpex.pilot.agent.shutdown(wait=True, timeout=10)
        dt = time.monotonic() - t0
        assert f.done() and f.result() == "done"
        assert dt < 5.0
    rpex.shutdown()


# --------------------------- event stream ------------------------------- #

def test_state_store_unified_event_stream():
    rpex = _hetero_rpex()
    try:
        @python_app
        def job(x):
            return x

        with DataFlowKernel(executors={"rpex": rpex}):
            assert job(9).result() == 9

        events = rpex.pool.events()
        kinds = {e["event"] for e in events}
        assert {"PILOT_START", "ROUTED", "STATE"} <= kinds
        states = [e["state"] for e in events if e.get("event") == "STATE"]
        for s in ("TRANSLATED", "SCHEDULED", "LAUNCHING", "RUNNING", "DONE"):
            assert s in states
        # per-pilot utilization is derivable from the stream
        util = rpex.utilization()
        assert set(util) == {p.uid for p in rpex.pool.pilots}
        fig6 = rpex.pilot.store.utilization(rpex.pilot.n_slots)
        assert abs(sum(fig6.values()) - 1.0) < 1e-6
    finally:
        rpex.shutdown()


def test_taskmanager_wait_subset_and_timeout():
    rpex = RPEXExecutor(PilotDescription(n_slots=2))
    try:
        gate = threading.Event()

        def quick():
            return "q"

        def slow():
            gate.wait(10)
            return "s"

        tq = translate(quick, (), {})
        ts = translate(slow, (), {})
        rpex.tmgr.submit(tq)
        rpex.tmgr.submit(ts)
        assert rpex.tmgr.wait(uids=[tq.uid], timeout=10)
        assert not rpex.tmgr.wait(timeout=0.2)     # slow still holds
        gate.set()
        assert rpex.tmgr.wait(timeout=10)
        assert ts.state == TaskState.DONE
    finally:
        gate.set()
        rpex.shutdown()


def test_dfk_per_executor_flush():
    """flush(label) drains exactly one executor's pending bulk batch."""
    r1 = RPEXExecutor(PilotDescription(n_slots=2))
    r2 = RPEXExecutor(PilotDescription(n_slots=2))
    r2.label = "rpex2"
    try:
        @python_app(executor="rpex")
        def a(x):
            return x

        @python_app(executor="rpex2")
        def b(x):
            return -x

        with DataFlowKernel(executors={"rpex": r1, "rpex2": r2}, bulk=True,
                            bulk_window=30.0) as dfk:
            fa = [a(i) for i in range(3)]
            fb = [b(i) for i in range(3)]
            dfk.flush("rpex")
            assert [f.result(timeout=10) for f in fa] == [0, 1, 2]
            assert dfk._pending_bulk.get("rpex2")  # still queued
            dfk.flush()
            assert [f.result(timeout=10) for f in fb] == [0, -1, -2]
    finally:
        r1.shutdown()
        r2.shutdown()
