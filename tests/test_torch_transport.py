"""WorkerTransport + serializer: the process/GIL boundary.

What must hold:
  * serializer round-trips: module-level functions by reference; closures,
    lambdas and nested functions by value; exceptions with their remote
    traceback; tensors/pytrees host-transferred to CPU tensors; graceful
    degradation for what cannot cross (results -> placeholder, globals ->
    dropped, exceptions -> RemoteError carrier);
  * the local pool is bounded AND reaped: a 64-task burst does not leave
    64 live threads at steady state, and the pool regrows afterwards;
  * transport="proc" runs python/bash bodies in worker processes with
    identical task semantics: results, remote exceptions (traceback
    preserved), unpicklable results completing (journal line slimmed),
    spmd staying inproc, checkpoint save/restore and cooperative
    preemption proxied over the control pipe.
"""
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import (DataFlowKernel, Pilot, RemoteError,
                              ResourceSpec, RPEXExecutor, TaskState,
                              UnserializableResult, bash_app, python_app,
                              spmd_app, translate)
from repro_torch.core import PilotDescription as _PilotDescription
from repro_torch.core import serializer
from repro_torch.core.transport import InprocTransport, ProcessTransport


def PilotDescription(*args, **kw):
    """The suite's pilot descriptions on the CPU, asked for explicitly: a
    description without devices means every CUDA device, and raises
    without a card."""
    kw.setdefault("devices", [torch.device("cpu")])
    return _PilotDescription(*args, **kw)

# ------------------------------ serializer ------------------------------- #

def test_module_level_function_roundtrips_by_reference():
    import os.path
    fn = serializer.loads(serializer.dumps(os.path.join))
    assert fn is os.path.join


def test_closure_roundtrips_by_value():
    base = 41

    def add(x):
        return base + x

    fn = serializer.loads(serializer.dumps(add))
    assert fn(1) == 42


def test_lambda_roundtrips():
    fn = serializer.loads(serializer.dumps(lambda x, y=3: x * y))
    assert fn(4) == 12
    assert fn(4, y=5) == 20


def test_nested_function_with_module_global():
    # `time` lives in this module's globals; it must travel as an import
    # reference, not a pickled module
    def stamp():
        return time.monotonic() >= 0

    fn = serializer.loads(serializer.dumps(stamp))
    assert fn() is True


_MODULE_LOCK = threading.Lock()        # an unpicklable module global


def test_unserializable_global_is_dropped_not_fatal():
    # a referenced global that cannot pickle is probed and dropped (a
    # call-time NameError on the branch that uses it, never a submit
    # failure); the rest of the function still ships and runs
    def uses_global(x):
        if x > 10**9:
            return _MODULE_LOCK        # never taken
        return x * 2

    fn = serializer.loads(serializer.dumps(uses_global))
    assert fn(4) == 8
    with pytest.raises(NameError):
        fn(10**9 + 1)


def test_exception_roundtrip_preserves_remote_traceback():
    def deep():
        raise ValueError("remote kaboom")

    try:
        deep()
    except ValueError as e:
        blob = serializer.pack_exception(e)
    exc = serializer.unpack_exception(blob)
    assert isinstance(exc, ValueError)
    assert "remote kaboom" in str(exc)
    assert "deep" in exc.remote_traceback
    assert "deep" in str(exc.__cause__)   # renders as the causal chain


def test_unpicklable_exception_degrades_to_remote_error():
    class Gnarly(Exception):              # nested class: not importable
        def __init__(self, a, b):
            super().__init__(f"{a}/{b}")
            self.lock = threading.Lock()  # and unpicklable state

    try:
        raise Gnarly("x", "y")
    except Exception as e:
        blob = serializer.pack_exception(e)
    exc = serializer.unpack_exception(blob)
    assert isinstance(exc, RemoteError)
    assert "Gnarly" in str(exc) and "x/y" in str(exc)
    assert "Gnarly" in exc.remote_traceback


def test_tensor_crosses_as_cpu_tensor():
    t = torch.arange(6, dtype=torch.float32, requires_grad=True) * 1.0
    out = serializer.loads(serializer.dumps(t))
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert not out.requires_grad            # detached before crossing
    np.testing.assert_array_equal(out.numpy(), np.arange(6, dtype=np.float32))


def test_tensor_pytree_leaves_host_transferred():
    tree = {"w": torch.ones((2, 2)), "meta": [torch.arange(3), "tag", 7]}
    out = serializer.loads(serializer.dumps(tree))
    assert isinstance(out["w"], torch.Tensor)
    assert isinstance(out["meta"][0], torch.Tensor)
    assert out["meta"][1:] == ["tag", 7]


def test_pack_result_degrades_gracefully():
    blob, info = serializer.pack_result({"ok": 1})
    assert blob is not None and info is None
    blob, info = serializer.pack_result(threading.Lock())
    assert blob is None
    assert info[0] == "lock" and "lock" in info[1]


# ----------------------------- pool hygiene ------------------------------ #

def _run_burst(pilot, n, sleep_s):
    done = threading.Event()
    remaining = [n]

    def cb(t):
        remaining[0] -= 1
        if remaining[0] == 0:
            done.set()

    for _ in range(n):
        t = translate(lambda s=sleep_s: time.sleep(s), (), {})
        t.transition(TaskState.TRANSLATED, pilot.store)
        assert pilot.agent.submit(t, done_cb=cb)
    assert done.wait(30)


@pytest.mark.timeout(60)
def test_burst_does_not_leave_threads_at_steady_state():
    """The hygiene regression: 64 concurrent tasks grow the pool to ~64
    threads, and idle reaping shrinks it back instead of leaking them
    for the agent's lifetime."""
    p = Pilot(PilotDescription(n_slots=64, max_workers=64,
                               worker_idle_s=0.3))
    try:
        _run_burst(p, 64, 0.3)
        tr = p.agent.transport
        assert tr.n_threads > 8          # the burst really fanned out
        deadline = time.monotonic() + 10
        while tr.n_threads > 0 and time.monotonic() < deadline:
            time.sleep(0.1)
        assert tr.n_threads == 0         # every idle worker reaped
        _run_burst(p, 8, 0.05)           # and the pool regrows on demand
    finally:
        p.close()


@pytest.mark.timeout(60)
def test_reaped_pool_still_drains_new_work():
    tr = InprocTransport(max_workers=4, idle_s=0.2)
    ran = []
    tr.start(lambda item: ran.append(item), executor=None)
    for i in range(4):
        tr.dispatch(i)
    deadline = time.monotonic() + 5
    while tr.n_threads > 0 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert tr.n_threads == 0
    tr.dispatch("after-reap")
    deadline = time.monotonic() + 5
    while "after-reap" not in ran and time.monotonic() < deadline:
        time.sleep(0.02)
    assert "after-reap" in ran
    tr.shutdown()


@pytest.mark.timeout(60)
def test_dispatch_after_shutdown_raises_instead_of_stranding():
    """Regression: a dispatch racing shutdown() could spawn a fresh
    thread that consumed a leftover poison pill and retired, leaving the
    task in the queue forever with no thread to drain it.  A closed pool
    must refuse loudly instead."""
    tr = InprocTransport(max_workers=4, idle_s=30.0)
    ran = []
    tr.start(lambda item: ran.append(item), executor=None)
    tr.dispatch("before")
    deadline = time.monotonic() + 5
    while "before" not in ran and time.monotonic() < deadline:
        time.sleep(0.02)
    assert "before" in ran
    tr.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        tr.dispatch("stranded")
    assert ran == ["before"]             # nothing silently swallowed
    # shutdown is idempotent and the refusal persists
    tr.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        tr.dispatch("still-stranded")


# ------------------------------ proc mode -------------------------------- #

def _proc_rpex(**kw):
    return RPEXExecutor(PilotDescription(n_slots=2, transport="proc", **kw))


@pytest.mark.timeout(120)
def test_proc_mode_runs_python_and_bash_bodies():
    rpex = _proc_rpex()
    try:
        base = 100

        @python_app
        def closure_add(a):
            return base + a

        @bash_app
        def greet(name):
            return f"echo hello-{name}"

        with DataFlowKernel(executors={"rpex": rpex}):
            fs = [closure_add(i) for i in range(8)]
            g = greet("proc")
            assert [f.result(timeout=30) for f in fs] == [100 + i
                                                          for i in range(8)]
            assert g.result(timeout=30).strip() == "hello-proc"
    finally:
        rpex.shutdown()


@pytest.mark.timeout(120)
def test_proc_mode_remote_exception_preserves_traceback():
    rpex = _proc_rpex()
    try:
        @python_app
        def boom():
            raise KeyError("remote-key")

        with DataFlowKernel(executors={"rpex": rpex}):
            f = boom()
            with pytest.raises(KeyError) as ei:
                f.result(timeout=30)
        assert "remote-key" in str(ei.value)
        assert "boom" in ei.value.remote_traceback
    finally:
        rpex.shutdown()


@pytest.mark.timeout(120)
def test_proc_mode_unpicklable_result_completes_and_journal_slims(tmp_path):
    """The docs/performance.md contract, extended across the boundary: a
    result that cannot cross completes the task with a placeholder, and
    the journal line is slimmed rather than the write failing."""
    journal = tmp_path / "proc.jsonl"
    rpex = RPEXExecutor(PilotDescription(n_slots=2, transport="proc",
                                         journal=str(journal)))
    try:
        @python_app
        def make_lock():
            import threading as th
            return th.Lock()

        with DataFlowKernel(executors={"rpex": rpex}):
            f = make_lock()
            out = f.result(timeout=30)
        assert isinstance(out, UnserializableResult)
        assert out.type_name == "lock"
        assert f.task.state == TaskState.DONE
    finally:
        rpex.shutdown()
    import json
    recs = [json.loads(l) for l in journal.read_text().splitlines() if l]
    done = [r for r in recs if r.get("uid") == f.task.uid
            and r.get("state") == "DONE"]
    assert done and all("result" not in r for r in done)


@pytest.mark.timeout(120)
def test_proc_mode_spmd_stays_inproc():
    """jit=False, as the port's other runtime tests: the in-process
    contract, without the body's torch.compile (the test below)."""
    rpex = RPEXExecutor(PilotDescription(n_slots=2, transport="proc"))
    try:
        @spmd_app(slots=2, jit=False)
        def double(mesh, x):
            return x * 2.0

        with DataFlowKernel(executors={"rpex": rpex}):
            f = double(torch.ones((4,)))
            np.testing.assert_allclose(np.asarray(f.result(timeout=60)),
                                       2.0 * np.ones((4,)))
        assert f.task.inproc_only
    finally:
        rpex.shutdown()


def test_proc_mode_spmd_jit_body_compiles_once_inproc():
    """The jit=True path under transport="proc": the body is wrapped once
    in torch.compile, runs in-process, and its second call reuses the
    compiled callable.  The first call compiles with inductor, tens of
    seconds on a loaded CPU with a cold cache, so results are awaited with
    no deadline and the test carries no timeout: it checks the path, not
    how fast the compiler runs."""
    rpex = RPEXExecutor(PilotDescription(n_slots=2, transport="proc"))
    try:
        @spmd_app(slots=2)
        def triple(mesh, x):
            return x * 3.0

        with DataFlowKernel(executors={"rpex": rpex}):
            futs = [triple(torch.ones((4,))) for _ in range(2)]
            for f in futs:
                np.testing.assert_allclose(np.asarray(f.result()),
                                           3.0 * np.ones((4,)))
        assert all(f.task.inproc_only for f in futs)
        executor = rpex.pool.pilots[0].executor
        assert [key[2] for key in executor._call_cache] == [True]   # jit
        assert executor.stats["compiles"] == 1
        assert executor.stats["cache_hits"] >= 1
    finally:
        rpex.shutdown()


@pytest.mark.timeout(120)
def test_proc_mode_unserializable_body_falls_back_inproc():
    """A body the serializer cannot ship (closure over a live lock that
    it *uses*) degrades to in-process execution instead of failing."""
    rpex = _proc_rpex()
    try:
        lock = threading.Lock()

        @python_app
        def guarded(x, _l=lock):       # unpicklable default: cannot ship
            with _l:
                return x + 1

        with DataFlowKernel(executors={"rpex": rpex}):
            assert guarded(41).result(timeout=30) == 42
    finally:
        rpex.shutdown()


# -------------------- proc checkpoint / preemption ----------------------- #

def _ckpt_body(n, ckpt=None):
    got = ckpt.restore()
    start = got[0] + 1 if got is not None else 0
    state = list(got[1]) if got is not None else []
    for step in range(start, n):
        state.append(step)
        ckpt.save(step, state)
        if got is None and step == 2:
            raise RuntimeError("induced crash after step 2")
    return (start, state)


@pytest.mark.timeout(120)
def test_proc_checkpoint_save_and_resume_across_retry():
    """First attempt saves steps 0..2 through the pipe then dies; the
    retry restores parent-side step 2 and resumes at 3 — each step runs
    exactly once, proving save/restore proxying is durable."""
    p = Pilot(PilotDescription(n_slots=2, transport="proc"))
    try:
        t = translate(_ckpt_body, (6,), {},
                      ResourceSpec(checkpointable=True), max_retries=1)
        t.transition(TaskState.TRANSLATED, p.store)
        done = threading.Event()
        box = {}

        def cb(task):
            box["state"] = task.state
            box["result"] = task.result
            done.set()

        assert p.agent.submit(t, done_cb=cb)
        assert done.wait(60)
        assert box["state"] == TaskState.DONE
        start, steps = box["result"]
        assert start == 3                # resumed, not recomputed
        assert steps == [0, 1, 2, 3, 4, 5]
        assert t.retries == 1
    finally:
        p.close()


@pytest.mark.timeout(120)
def test_proc_cooperative_preempt_crosses_the_pipe():
    """agent.preempt() on a proc-mode task forwards the flag down the
    worker pipe; the body unwinds at its next save with the step durable
    parent-side, and a resubmission resumes from it."""
    p = Pilot(PilotDescription(n_slots=2, transport="proc"))
    try:
        def slow_ckpt(n, ckpt=None):
            got = ckpt.restore()
            start = got[0] + 1 if got is not None else 0
            state = list(got[1]) if got is not None else []
            for step in range(start, n):
                time.sleep(0.05)
                state.append(step)
                ckpt.save(step, state)
            return (start, state)

        t = translate(slow_ckpt, (20,), {},
                      ResourceSpec(checkpointable=True))
        t.transition(TaskState.TRANSLATED, p.store)
        done = threading.Event()
        box = {}

        def cb(task):
            box["result"] = task.result
            done.set()

        handed = threading.Event()

        def handoff(task, task_cb):
            if task is None:
                return               # overtaken by a normal finish
            box["handed"] = task
            box["cb"] = task_cb
            handed.set()

        assert p.agent.submit(t, done_cb=cb)
        deadline = time.monotonic() + 30
        while p.ckpt.step(t.ckpt_key) is None:
            assert time.monotonic() < deadline, "no checkpoint ever saved"
            time.sleep(0.02)
        assert p.agent.preempt(t.uid, handoff)
        assert handed.wait(30), "preempt never unwound the remote body"
        saved = p.ckpt.step(t.ckpt_key)
        assert saved is not None and saved >= 0
        assert box["handed"].state == TaskState.TRANSLATED

        # resubmit the handed-off task: it must resume past the saved step
        assert p.agent.submit(box["handed"], done_cb=box["cb"] or cb)
        assert done.wait(60)
        start, steps = box["result"]
        assert start == saved + 1        # resumed from the preempt point
        assert steps == list(range(20))  # and every step ran exactly once
    finally:
        p.close()


# ----------------------------- mixed pools ------------------------------- #

@pytest.mark.timeout(120)
def test_heterogeneous_pool_mixes_transports():
    """One pool, one executor: an inproc device pilot for spmd next to a
    proc CPU pilot for python — both kinds complete."""
    rpex = RPEXExecutor([
        PilotDescription(n_slots=2, kinds=("spmd",), name="dev"),
        PilotDescription(n_slots=2, kinds=("python", "bash"),
                         transport="proc", name="cpu"),
    ])
    try:
        @spmd_app(slots=2, jit=False)
        def scale(mesh, x):
            return x * 3.0

        @python_app
        def pyadd(a, b):
            return a + b

        with DataFlowKernel(executors={"rpex": rpex}):
            fs = scale(torch.ones((4,)))
            fp = pyadd(20, 22)
            np.testing.assert_allclose(np.asarray(fs.result(timeout=60)),
                                       3.0 * np.ones((4,)))
            assert fp.result(timeout=30) == 42
        dev, cpu = rpex.pool.pilots
        assert isinstance(dev.agent.transport, InprocTransport)
        assert isinstance(cpu.agent.transport, ProcessTransport)
    finally:
        rpex.shutdown()


def test_inproc_default_and_transport_validation():
    d = PilotDescription()
    assert d.transport == "inproc"
    with pytest.raises(ValueError):
        from repro_torch.core import make_transport
        make_transport("carrier-pigeon")
