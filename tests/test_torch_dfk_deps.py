"""DFK batched dependency resolution: wide fan-in/fan-out correctness
under concurrency, upstream-failure propagation through the dependency
manager, and the flush-vs-flusher race (the old per-window Timer's
double-submit hazard, now a persistent flusher thread)."""
import threading
import time

import pytest
import torch

from repro_torch.core import (DataFlowKernel, Executor, RPEXExecutor,
                              python_app)
from repro_torch.core import PilotDescription as _PilotDescription


def PilotDescription(*args, **kw):
    """The suite's pilot descriptions on the CPU, asked for explicitly: a
    description without devices means every CUDA device, and raises
    without a card."""
    kw.setdefault("devices", [torch.device("cpu")])
    return _PilotDescription(*args, **kw)
pytestmark = pytest.mark.timeout(120)    # race tests must fail, not wedge


class ManualExecutor(Executor):
    """Records every submission; tasks run only when the test says so —
    full control over producer-completion timing and batch boundaries."""

    label = "manual"
    supports_bulk = True

    def __init__(self):
        self.lock = threading.Lock()
        self.pending = []          # (ParslTask, AppFuture) not yet run
        self.bulk_batches = []     # list of batch sizes, in arrival order
        self.singles = 0

    def submit(self, pt, fut):
        with self.lock:
            self.singles += 1
            self.pending.append((pt, fut))

    def submit_bulk(self, pairs):
        with self.lock:
            self.bulk_batches.append(len(pairs))
            self.pending.extend(pairs)

    def run_pending(self):
        with self.lock:
            batch, self.pending = self.pending, []
        for pt, fut in batch:
            try:
                fut.set_result(pt.fn(*pt.args, **pt.kwargs))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)
        return len(batch)

    def wait_for(self, pred, timeout=5.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self.lock:
                if pred(self):
                    return True
            time.sleep(0.002)
        return False


# ------------------------------ fan-in ---------------------------------- #

def test_wide_fanin_launches_exactly_once_under_concurrency():
    """N producers completing concurrently in agent worker threads race
    their decrements on the consumer's dep counter; the consumer must
    launch exactly once with all inputs resolved."""
    rpex = RPEXExecutor(PilotDescription(n_slots=4))
    try:
        launches = []

        @python_app
        def produce(i):
            return i

        @python_app
        def aggregate(xs):
            launches.append(len(xs))
            return sum(xs)

        with DataFlowKernel(executors={"rpex": rpex}):
            for round_ in range(5):
                futs = [produce(i) for i in range(64)]
                total = aggregate(futs).result(timeout=30)
                assert total == sum(range(64))
        assert launches == [64] * 5, "aggregate launched more than once"
    finally:
        rpex.shutdown()


def test_fanout_launches_in_one_bulk_pass():
    """One producer feeding N consumers: when it completes, the ready
    batch flows into the per-executor bulk buffer and is drained as one
    submit_bulk pass — not N callback chains or N timer windows."""
    ex = ManualExecutor()

    def produce():
        return 7

    def consume(x, i):
        return x * 10 + i

    # bulk_window far beyond the test timeout: only the immediate
    # dependency-ready flush can deliver the consumer batch
    with DataFlowKernel(executors={"manual": ex}, bulk=True,
                        bulk_window=30.0) as dfk:
        fp = dfk.submit(produce)
        futs = [dfk.submit(consume, (fp, i)) for i in range(128)]
        dfk.flush()                      # push the producer itself
        assert ex.run_pending() == 1     # producer completes...
        assert ex.wait_for(lambda e: sum(e.bulk_batches) >= 129), \
            "dependency-ready batch never flushed"
        assert max(ex.bulk_batches) == 128, (
            f"fan-out split into {ex.bulk_batches} instead of one pass")
        ex.run_pending()
        assert sorted(f.result(timeout=5) for f in futs) == \
            [70 + i for i in range(128)]


def test_deep_chain_through_batched_manager():
    rpex = RPEXExecutor(PilotDescription(n_slots=2))
    try:
        @python_app
        def inc(x):
            return x + 1

        with DataFlowKernel(executors={"rpex": rpex}, bulk=True) as dfk:
            f = inc(0)
            for _ in range(39):
                f = inc(f)
            dfk.flush()
            assert f.result(timeout=30) == 40
    finally:
        rpex.shutdown()


def test_dep_on_just_completed_future_races():
    """Producers that complete during consumer registration must still
    decrement exactly once — stress the done-at-registration path."""
    rpex = RPEXExecutor(PilotDescription(n_slots=4))
    try:
        @python_app
        def quick(i):
            return i

        @python_app
        def follow(x):
            return x + 1000

        with DataFlowKernel(executors={"rpex": rpex}):
            pairs = []
            for i in range(200):
                fp = quick(i)          # may complete before follow(fp)
                pairs.append((i, follow(fp)))
            for i, f in pairs:
                assert f.result(timeout=30) == i + 1000
    finally:
        rpex.shutdown()


# ---------------------- cross-producer coalescing ------------------------ #

def test_near_simultaneous_producer_completions_coalesce():
    """Producers completing while a decrement drain is in flight are
    combined into that drain (their threads return immediately) instead
    of each paying a contended pass — and the combined pass still
    launches every ready consumer exactly once."""
    ex = ManualExecutor()
    with DataFlowKernel(executors={"manual": ex}) as dfk:
        p1 = dfk.submit(lambda: 1)
        p2 = dfk.submit(lambda: 2)
        c = dfk.submit(lambda a, b: a + b, (p1, p2))

        # simulate an in-flight drain: both producers complete while the
        # drainer flag is held, so their done-callbacks must enqueue and
        # bail out without touching the consumer counters
        with dfk._dep_lock:
            dfk._dep_draining = True
        ex.run_pending()                     # completes p1 and p2
        assert p1.done() and p2.done()
        assert len(dfk._producer_q) == 2, "completions were not queued"
        assert dfk.dep_coalesced == 2
        assert not ex.pending, "consumer launched during a foreign drain"

        # release the flag; the next completion drains the whole backlog
        # in one combined pass (duplicate producer entries are idempotent)
        with dfk._dep_lock:
            dfk._dep_draining = False
        dfk._on_producer_done(p1)
        assert ex.wait_for(lambda e: len(e.pending) == 1), \
            "combined drain never launched the consumer"
        ex.run_pending()
        assert c.result(timeout=5) == 3


def test_coalesced_wide_fanin_launches_once_and_correctly():
    """The combining path under real concurrency: many producers finish
    across agent workers; whatever interleaving the drainer sees, each
    consumer launches exactly once with all inputs resolved (and at
    least some completions should have combined)."""
    rpex = RPEXExecutor(PilotDescription(n_slots=4))
    try:
        @python_app
        def produce(i):
            return i

        @python_app
        def aggregate(xs):
            return sum(xs)

        with DataFlowKernel(executors={"rpex": rpex}) as dfk:
            totals = []
            for _ in range(5):
                futs = [produce(i) for i in range(64)]
                totals.append(aggregate(futs).result(timeout=30))
            assert totals == [sum(range(64))] * 5
            # not asserted deterministically (scheduling-dependent), but
            # record the stat so regressions in the combining path show
            # up in -v output
            print(f"dep_coalesced={dfk.dep_coalesced}")
    finally:
        rpex.shutdown()


# ------------------------ failure propagation --------------------------- #

@pytest.mark.parametrize("bulk", [False, True])
def test_upstream_failure_propagates_and_consumer_never_runs(bulk):
    rpex = RPEXExecutor(PilotDescription(n_slots=2))
    try:
        ran = []

        @python_app
        def boom():
            raise ValueError("upstream boom")

        @python_app
        def after(x):
            ran.append(x)
            return x

        with DataFlowKernel(executors={"rpex": rpex}, bulk=bulk) as dfk:
            f1 = boom()
            f2 = after(f1)
            if bulk:
                dfk.flush()
            with pytest.raises(ValueError, match="upstream boom"):
                f2.result(timeout=10)
        assert ran == []
    finally:
        rpex.shutdown()


def test_partial_failure_wide_fanin():
    """One failed producer out of many fails the consumer (with the
    producer's error), after all producers settle."""
    rpex = RPEXExecutor(PilotDescription(n_slots=4))
    try:
        ran = []

        @python_app
        def produce(i):
            if i == 13:
                raise RuntimeError("producer 13 failed")
            return i

        @python_app
        def aggregate(xs):
            ran.append(1)
            return sum(xs)

        with DataFlowKernel(executors={"rpex": rpex}):
            futs = [produce(i) for i in range(32)]
            fagg = aggregate(futs)
            with pytest.raises(RuntimeError, match="producer 13"):
                fagg.result(timeout=30)
        assert ran == []
    finally:
        rpex.shutdown()


def test_failure_nested_inside_structure_propagates():
    rpex = RPEXExecutor(PilotDescription(n_slots=2))
    try:
        @python_app
        def boom():
            raise KeyError("nested boom")

        @python_app
        def consume(payload):
            return payload

        with DataFlowKernel(executors={"rpex": rpex}):
            f = consume({"results": [boom()]})   # future inside dict/list
            with pytest.raises(KeyError):
                f.result(timeout=10)
    finally:
        rpex.shutdown()


# ------------------------- flush-vs-flusher race ------------------------- #

def test_manual_flush_vs_flusher_never_double_submits():
    """Regression for the Timer-era race: explicit flush() calls hammering
    the DFK while the background flusher drains deadline batches must
    submit every task exactly once."""
    ex = ManualExecutor()
    done = threading.Event()

    def runner():                      # complete whatever arrives
        while not done.is_set():
            ex.run_pending()
            time.sleep(0.001)
        ex.run_pending()

    run_th = threading.Thread(target=runner, daemon=True)
    run_th.start()
    try:
        with DataFlowKernel(executors={"manual": ex}, bulk=True,
                            bulk_window=0.001) as dfk:
            futs = []
            flock = threading.Lock()
            stop_flush = threading.Event()

            def hammer():
                while not stop_flush.is_set():
                    dfk.flush()

            flushers = [threading.Thread(target=hammer, daemon=True)
                        for _ in range(2)]
            for t in flushers:
                t.start()

            def feeder(base):
                for i in range(100):
                    f = dfk.submit(lambda v=base + i: v)
                    with flock:
                        futs.append(f)

            feeders = [threading.Thread(target=feeder, args=(k * 1000,))
                       for k in range(3)]
            for t in feeders:
                t.start()
            for t in feeders:
                t.join()
            results = sorted(f.result(timeout=30) for f in futs)
            stop_flush.set()
            for t in flushers:
                t.join(timeout=5)
        want = sorted(k * 1000 + i for k in range(3) for i in range(100))
        assert results == want
        assert ex.singles + sum(ex.bulk_batches) == 300, (
            "a batch was submitted twice (or dropped): "
            f"{ex.singles} singles + {ex.bulk_batches}")
    finally:
        done.set()
        run_th.join(timeout=5)


def test_window_flush_fires_without_manual_flush():
    """The persistent flusher honors bulk_window deadlines on its own."""
    ex = ManualExecutor()
    with DataFlowKernel(executors={"manual": ex}, bulk=True,
                        bulk_window=0.005) as dfk:
        futs = [dfk.submit(lambda v=i: v) for i in range(10)]
        assert ex.wait_for(lambda e: sum(e.bulk_batches) == 10, timeout=5), \
            "window deadline never flushed the batch"
        ex.run_pending()
        assert sorted(f.result(timeout=5) for f in futs) == list(range(10))
