"""DFK + translator + RPEX + agent integration behaviour."""
import time

import pytest
import torch

from repro_torch.core import (DataFlowKernel, ResourceSpec,
                              RPEXExecutor, TaskState, ThreadPoolExecutor,
                              bash_app, python_app, spmd_app, translate,
                              detect_kind)
from repro_torch.core import PilotDescription as _PilotDescription


def PilotDescription(*args, **kw):
    """The suite's pilot descriptions on the CPU, asked for explicitly: a
    description without devices means every CUDA device, and raises
    without a card."""
    kw.setdefault("devices", [torch.device("cpu")])
    return _PilotDescription(*args, **kw)


@pytest.fixture()
def rpex():
    ex = RPEXExecutor(PilotDescription(n_slots=8))
    yield ex
    ex.shutdown()


def test_translator_kind_detection():
    @python_app
    def f():
        return 1

    @spmd_app(slots=2)
    def g(mesh):
        return 2

    @bash_app
    def h():
        return "echo hi"

    assert detect_kind(f.__wrapped_app__) == "python"
    assert detect_kind(g.__wrapped_app__) == "spmd"
    assert detect_kind(h.__wrapped_app__) == "bash"
    t = translate(g.__wrapped_app__, (), {})
    assert t.resources.slots == 2
    assert t.kind == "spmd"


def test_resource_spec_validation():
    with pytest.raises(ValueError):
        ResourceSpec(slots=0)
    with pytest.raises(ValueError):
        ResourceSpec(slots=4, mesh_shape=(3, 2))
    ResourceSpec(slots=6, mesh_shape=(3, 2))


def test_dataflow_dependencies(rpex):
    order = []

    @python_app
    def a():
        order.append("a")
        return 1

    @python_app
    def b(x):
        order.append("b")
        return x + 1

    @python_app
    def c(x, y):
        order.append("c")
        return x + y

    with DataFlowKernel(executors={"rpex": rpex}):
        fa = a()
        fb = b(fa)
        fc = c(fa, fb)
        assert fc.result() == 3
    assert order.index("a") < order.index("b") < order.index("c")


def test_failure_propagates_downstream(rpex):
    @python_app
    def boom():
        raise ValueError("boom")

    @python_app
    def after(x):
        return x

    with DataFlowKernel(executors={"rpex": rpex}):
        f1 = boom()
        f2 = after(f1)
        with pytest.raises(ValueError):
            f2.result()


def test_executable_cache_reuse(rpex):
    @spmd_app(slots=2)
    def t(mesh, x):
        return x * 2.0

    with DataFlowKernel(executors={"rpex": rpex}):
        futs = [t(float(i)) for i in range(8)]
        assert [f.result() for f in futs] == [i * 2.0 for i in range(8)]
    assert rpex.pilot.executor.stats["compiles"] == 1
    assert rpex.pilot.executor.stats["cache_hits"] >= 7


def test_bulk_submission(rpex):
    @python_app
    def inc(x):
        return x + 1

    with DataFlowKernel(executors={"rpex": rpex}, bulk=True) as dfk:
        futs = [inc(i) for i in range(20)]
        dfk.flush()
        assert [f.result() for f in futs] == list(range(1, 21))


def test_retry_on_failure(rpex):
    attempts = []

    @python_app(retries=2)
    def flaky():
        attempts.append(1)
        if len(attempts) < 3:
            raise RuntimeError("transient")
        return "ok"

    with DataFlowKernel(executors={"rpex": rpex}):
        assert flaky().result() == "ok"
    assert len(attempts) == 3


def test_slot_failure_mid_run(rpex):
    import threading
    release = threading.Event()

    @spmd_app(slots=2, retries=1, jit=False)
    def slow(mesh):
        release.wait(5.0)
        return "done"

    with DataFlowKernel(executors={"rpex": rpex}):
        f = slow()
        time.sleep(0.3)                      # let it start running
        victims = rpex.pilot.agent.inject_slot_failure([0, 1])
        release.set()
        # first attempt fails (poisoned error), retry lands on good slots
        assert f.result(timeout=30) == "done"
    assert rpex.pilot.scheduler.capacity == 6


def test_elastic_grow_shrink(rpex):
    p = rpex.pilot
    assert p.n_slots == 8
    p.grow(8)
    assert p.n_slots == 16

    @spmd_app(slots=16, jit=False)
    def wide(mesh):
        return "wide-ok"

    with DataFlowKernel(executors={"rpex": rpex}):
        assert wide().result() == "wide-ok"
    p.shrink(8)
    assert p.n_slots == 8


def test_threadpool_executor_baseline():
    @python_app
    def f(x):
        return x * 3

    with DataFlowKernel(executors={"threads": ThreadPoolExecutor(4)}):
        assert f(5).result() == 15


def test_priority_scheduling(rpex):
    """Higher-priority tasks jump the wait queue."""
    import threading
    gate = threading.Event()
    ran = []

    @spmd_app(slots=8, jit=False)
    def hog(mesh):
        gate.wait(10)
        return "hog"

    @spmd_app(slots=8, jit=False, priority=0)
    def low(mesh):
        ran.append("low")
        return "low"

    @spmd_app(slots=8, jit=False, priority=5)
    def high(mesh):
        ran.append("high")
        return "high"

    with DataFlowKernel(executors={"rpex": rpex}):
        fh = hog()
        time.sleep(0.2)
        fl = low()
        fg = high()
        time.sleep(0.2)
        gate.set()
        fl.result(timeout=30)
        fg.result(timeout=30)
    assert ran[0] == "high"
