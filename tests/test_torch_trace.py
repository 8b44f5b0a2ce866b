"""The port's recorder (``repro_torch.trace``) on the CPU: off it records,
calls and allocates nothing; on, under the profiler as the benchmark runs
it, spans nest, carry their task on a pilot's agent thread and on a thread
that runs a backward (and take none where two backwards run at once), and
lie on the profiler's clock; sessions, counters, the bounded buffer and
compiled code."""
import itertools
import threading
import tracemalloc
import types

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs as TC
from repro_torch import trace
from repro_torch.core import (DataFlowKernel, PilotDescription, RPEXExecutor,
                              python_app, spmd_app)
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.optim import AdamW


def harness_profile():
    """The benchmark's traced run: host ops on every thread."""
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return profile(activities=[ProfilerActivity.CPU], experimental_config=cfg)


def boom(*args, **kw):
    raise AssertionError("called while tracing is off")


def test_off_a_span_records_calls_and_allocates_nothing(monkeypatch):
    assert not trace.RECORDER.on
    before = trace.snapshot()
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(trace, "Span", boom)
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(time_ns=boom))
    with trace.span("train.step", device=True, task="t") as sp:
        assert sp is None
        with trace.span("layer.mamba"):
            trace.count("calls")
    after = trace.snapshot()
    assert after.spans == before.spans and after.counters == before.counters
    monkeypatch.undo()

    span, times = trace.span, itertools.repeat(None, 2000)
    tracemalloc.start()
    try:
        with span("layer.attn"):
            pass
        tracemalloc.reset_peak()
        base = tracemalloc.get_traced_memory()[0]
        for _ in times:
            with span("layer.attn"):
                pass
        current, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # nothing kept, and no block a span: the interpreter's ``with`` takes
    # one small block once, whatever the count
    assert current == base and peak - base <= 256


class _Probe(torch.autograd.Function):
    """The identity, whose backward opens a span (as the remat recompute
    of a layer does on autograd's thread)."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        with trace.span("layer.probe"):
            return g


def _tiny_step():
    cfg = TC.reduce_config(TC.get_config("mamba2-1.3b"))
    params = TT.init_params(cfg, 0, device="cpu")
    opt = AdamW()
    step = TM.make_train_step(cfg, opt)
    tok = torch.randint(0, cfg.vocab_size, (2, 17), dtype=torch.int32)
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:],
             "loss_mask": torch.ones(2, 16)}
    return step, params, opt.init(params), batch


def test_spans_carry_parents_and_tasks_on_agent_and_autograd_threads():
    step, params, state, batch = _tiny_step()

    @spmd_app(slots=1, jit=False)
    def train_segment(mesh):
        step(params, state, batch)
        return threading.get_native_id()

    rpex = RPEXExecutor(PilotDescription(n_slots=2,
                                         devices=[torch.device("cpu")]))
    x = torch.ones(3, requires_grad=True)
    try:
        with harness_profile() as prof:
            assert trace.RECORDER.on
            with DataFlowKernel(executors={"rpex": rpex}):
                fut = train_segment()
                agent_thread = fut.result(timeout=120)
            # a backward run by another thread while this one waits in a
            # lender, as autograd's own thread runs a CUDA backward
            y = _Probe.apply(x).sum()
            with trace.span("task.body", task="task-b"):
                with trace.span("train.backward", lend=True) as lender:
                    t = threading.Thread(
                        target=lambda: torch.autograd.grad(y, x))
                    t.start()
                    t.join(60)
            assert not t.is_alive()
            # outside a backward, a thread with no span adopts nothing
            t = threading.Thread(target=lambda: trace.span("free").__enter__()
                                 .__exit__(None, None, None))
            t.start()
            t.join(60)
        rpex.shutdown()
    finally:
        rpex.shutdown()
    assert not trace.RECORDER.on
    snap = trace.snapshot()
    uid = fut.task.uid
    body = [s for s in snap.named("task.body") if s.task == uid]
    assert len(body) == 1 and body[0].thread == agent_thread
    assert body[0].parent.name == "agent.dispatch"
    assert body[0].attrs["fn"] == "train_segment"
    chain = {"train.step": "task.body", "train.forward": "train.step",
             "train.backward": "train.step", "train.optimizer": "train.step"}
    for name, parent in chain.items():
        (s,) = [x for x in snap.named(name) if x.task == uid]
        assert s.parent.name == parent and s.thread == agent_thread, s
    mixers = snap.named("layer.mamba")
    # 2 layers in the forward and again in the remat recompute
    assert len(mixers) == 4 and all(s.task == uid for s in mixers)
    assert sorted(s.parent.name for s in mixers) == [
        "train.backward", "train.backward", "train.forward", "train.forward"]
    assert snap.counters == {}              # the program counts nothing
    (probe,) = snap.named("layer.probe")
    assert probe.parent is lender and probe.task == "task-b"
    assert probe.thread != lender.thread
    (free,) = snap.named("free")
    assert free.parent is None and free.task is None

    # every span lies on the profiler's clock: within 1 ms of the range
    # the profiler recorded for it, which opens before the span's start
    # and closes after its end
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        ranges.setdefault(e.name(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    for s in snap.spans:
        assert any(a - 1e6 <= s.start_ns <= s.end_ns <= b + 1e6
                   for a, b in ranges.get(s.name, ())), s


def test_two_backwards_at_once_lend_no_parent():
    """Two agent threads each wait in a lender while another thread runs
    their backward, as autograd's thread runs the CUDA backwards of two
    tasks at once: a span inside either backward cannot tell whose it is,
    and takes no parent and no task."""
    both = threading.Barrier(2, timeout=30)

    def agent(task):
        x = torch.ones(3, requires_grad=True)
        y = _Probe.apply(x).sum()
        with trace.span("task.body", task=task):
            with trace.span("train.backward", lend=True):
                both.wait()                 # both lenders open
                t = threading.Thread(target=lambda: torch.autograd.grad(y, x))
                t.start()
                t.join(60)
                both.wait()                 # until both backwards ran

    agents = [threading.Thread(target=agent, args=(f"task-{k}",))
              for k in "ab"]
    with harness_profile():
        for t in agents:
            t.start()
        for t in agents:
            t.join(60)
    assert not any(t.is_alive() for t in agents)
    snap = trace.snapshot()
    assert sorted(s.task for s in snap.named("train.backward")) == [
        "task-a", "task-b"]
    probes = snap.named("layer.probe")
    assert len(probes) == 2
    assert all(p.parent is None and p.task is None for p in probes), probes


def test_a_launch_names_its_producer_and_the_task_it_launched():
    gate = threading.Event()

    @python_app
    def produce():
        gate.wait(30)
        return 1

    @python_app
    def consume(x):
        return x + 1

    rpex = RPEXExecutor(PilotDescription(n_slots=2,
                                         devices=[torch.device("cpu")]))
    trace.enable()
    try:
        with DataFlowKernel(executors={"rpex": rpex}):
            first = produce()
            second = consume(first)         # waits on ``first``
            gate.set()
            assert second.result(timeout=60) == 2
    finally:
        trace.disable()
        rpex.shutdown()
    snap = trace.snapshot()
    (launch,) = snap.named("dfk.launch")
    p, c = first.task.uid, second.task.uid
    assert launch.attrs == {"cause": [p], "tasks": [c]}
    # the producer's worker launches its consumer as it finishes
    assert launch.task == p and launch.parent.name == "agent.dispatch"
    bodies = {s.task: s for s in snap.named("task.body")}
    assert bodies[c].attrs["fn"] == "consume"
    assert bodies[p].end_ns <= launch.start_ns <= bodies[c].start_ns


def test_a_new_session_drops_the_last():
    for start, stop in ((lambda: harness_profile().__enter__(), None),
                        (trace.enable, trace.disable)):
        names = []
        for name in ("first", "second"):
            prof = start()
            with trace.span(name):
                pass
            prof.__exit__(None, None, None) if stop is None else stop()
            names.append([s.name for s in trace.snapshot().spans])
        assert names == [["first"], ["second"]]
        assert trace.snapshot().end_ns is not None


def test_counters_watched_counters_and_the_bounded_buffer():
    rec = trace.Recorder(limit=3)
    rec.count("calls")                      # off: not counted
    rec.enable()
    rec.count("calls", 2)
    rec.count("calls")
    for _ in range(5):
        with rec.span("x"):
            pass
    rec.disable()
    rec.count("calls")                      # after the session
    snap = rec.snapshot()
    assert snap.counters == {"calls": 3}
    assert len(snap.spans) == 3 and snap.dropped == 2
    rec.enable()                            # a new session counts anew
    rec.count("calls")
    rec.disable()
    assert rec.snapshot().counters == {"calls": 1}


def test_compiled_code_passes_spans_through():
    def f(x):
        with trace.span("layer.attn"):
            y = x * 2
        with trace.span("train.step", device=True):
            return y + 1
    g = torch.compile(f, backend="eager", fullgraph=True)
    assert g(torch.ones(2)).tolist() == [3.0, 3.0]
    trace.enable()
    try:
        assert g(torch.ones(2)).tolist() == [3.0, 3.0]
    finally:
        trace.disable()
