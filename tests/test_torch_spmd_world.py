"""The pilot world (``PilotDescription(ranks=N)``, spmd_world.py) on the
CPU: gloo ranks, their cached groups, the collectives, results that stay
on the ranks, and faults.

One 4-rank world serves the module (it is persistent, as a pilot's is);
the kill test and the cache tests start their own.  Task bodies are
defined inside the tests, so they cross to the ranks by value and the
ranks import nothing of this module (the isolation test reads their
``sys.modules``).
"""
import gc
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import (DataFlowKernel, P, PilotDescription,
                              RPEXExecutor, RankRef, StaleRankRef, TaskState,
                              WorkerDied, all_gather, fetch_refs, pmean, psum,
                              python_app, shard_map, spmd_app)
from repro_torch.core.store import EVENTS

CPU = [torch.device("cpu")]


def _rpex(**kw):
    kw.setdefault("devices", CPU)
    return RPEXExecutor(PilotDescription(**kw))


class _Kept:
    """The module's executor as a test's DFK sees it: the DFK shuts its
    executors down on exit, and this one outlives each test."""

    def __init__(self, ex):
        self._ex = ex

    def __getattr__(self, name):
        return getattr(self._ex, name)

    def shutdown(self):
        pass


@pytest.fixture(scope="module")
def rpex():
    ex = _rpex(n_slots=8, ranks=4)
    yield ex
    ex.shutdown()


def _dfk(rpex):
    return DataFlowKernel(executors={"rpex": _Kept(rpex)})


def _events(rpex, name):
    return [e for e in rpex.pilot.store.events_snapshot()
            if e["event"] == name]


@pytest.mark.timeout(120)
def test_spmd_submesh_collective(rpex):
    """The reference's ``test_spmd_submesh_collective``: a 4-slot psum of
    ``arange(8) * 2`` is 56.0 in-process (one device, the identity
    collective, compiled as the reference's is) and on the world (a gloo
    all_reduce over 4 ranks, eager), as the reference computes it."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from repro.compat import shard_map as jshard_map
    from repro.core import spmd_app as jspmd_app
    from repro.core import DataFlowKernel as JDFK
    from repro.core import PilotDescription as JPD
    from repro.core import RPEXExecutor as JRPEX

    @jspmd_app(slots=4)
    def ref_task(mesh, x):
        arr = jnp.arange(8.0) * x
        f = jshard_map(lambda a: jax.lax.psum(a.sum(), "data"),
                       mesh=mesh, in_specs=JP("data"), out_specs=JP())
        return f(arr)

    ref = JRPEX(JPD(n_slots=8))
    with JDFK(executors={"rpex": ref}):
        want = float(ref_task(2).result())
    ref.shutdown()

    def body(mesh, x):
        arr = torch.arange(8.0) * x
        f = shard_map(lambda a: psum(a.sum(), "data"),
                      mesh=mesh, in_specs=P("data"), out_specs=P())
        return f(arr)

    psum_task = spmd_app(slots=4)(body)
    inproc = _rpex(n_slots=8)
    try:
        with DataFlowKernel(executors={"rpex": inproc}):
            assert float(psum_task(2).result()) == want == 56.0
    finally:
        inproc.shutdown()
    with _dfk(rpex):
        got = spmd_app(slots=4, jit=False)(body)(2).result()
        assert isinstance(got, RankRef) and got.ranks == (0, 1, 2, 3)
        assert float(got) == want


@pytest.mark.timeout(300)
@pytest.mark.parametrize("cache", [True, False], ids=["cached", "cold"])
def test_executable_cache_reuse_with_jit(cache):
    """The reference's ``test_executable_cache_reuse`` as it is written,
    with ``spmd_app``'s default ``jit=True``, on a 2-rank world (8 slots:
    every 2-slot block is ranks {0, 1}).  Each float reaches the compiled
    body as a 0-d tensor, as ``jax.jit`` traces it, so each result is a
    ``RankRef`` of one.  Cached, one compile serves the 8 tasks (7 hits):
    dynamo compiles graphs in the ranks for the first task alone, under
    the key the parent sent, and not again for the 7 other values (a
    recompile would show as graphs in a later task); cold (the paper's
    ablation), every task compiles, in the parent's count and in the
    ranks."""
    @spmd_app(slots=2)
    def t(mesh, x):
        return x * 2.0

    ex = _rpex(n_slots=8, ranks=2, cache_executables=cache)
    try:
        with DataFlowKernel(executors={"rpex": _Kept(ex)}):
            futs = [t(float(i)) for i in range(8)]
            assert [float(f.result()) for f in futs] == [i * 2.0
                                                         for i in range(8)]
        stats = dict(ex.pilot.executor.stats)
        # the ranks run the tasks one at a time, in the world's order
        graphs = [c["graphs"] for c in ex.pilot.world.calls]
    finally:
        ex.shutdown()
    assert len(graphs) == 8 and graphs[0] >= 1
    if cache:
        assert stats["compiles"] == 1 and stats["cache_hits"] >= 7
        assert graphs[1:] == [0] * 7
    else:
        assert stats == {"compiles": 8, "cache_hits": 0}
        assert all(g >= 1 for g in graphs)


@pytest.mark.timeout(120)
def test_call_records_keep_dispatch_order(rpex, monkeypatch):
    """``world.calls`` is in the order the tasks were dispatched, which is
    the order the ranks ran them, even when the parent thread of the
    first task gathers its replies after the second task's thread has
    recorded its own (as happens under load): the first task's gather is
    held here until the second task's record is in."""
    world = rpex.pilot.world
    real_wait = world._wait
    posted = threading.Event()

    def second_recorded():
        return any(c["uid"] == "second" for c in list(world.calls))

    def wait(seq, call, what, *args, **kwargs):
        replies = real_wait(seq, call, what, *args, **kwargs)
        if what == "task first":
            posted.set()
            deadline = time.monotonic() + 60
            while not second_recorded() and time.monotonic() < deadline:
                time.sleep(0.01)
        return replies

    monkeypatch.setattr(world, "_wait", wait)
    first = threading.Thread(target=world.run, args=(
        lambda mesh: 1, (), {}, (0, 1), (2, 1)), kwargs={"uid": "first"})
    first.start()
    assert posted.wait(60)
    world.run(lambda mesh: 2, (), {}, (0, 1), (2, 1), uid="second")
    first.join(60)
    assert not first.is_alive() and second_recorded()
    mine = [c for c in list(world.calls) if c["uid"] in ("first", "second")]
    assert [c["uid"] for c in mine] == ["first", "second"]
    assert mine[0]["seq"] < mine[1]["seq"]


@pytest.mark.timeout(300)
def test_jit_body_on_two_ranks_matches_eager(rpex):
    """A compiled body on a (2, 1) block: each rank multiplies its own
    slice of ``x`` by ``w`` and scales it by a float (a 0-d tensor in the
    graph), and the block sums them (a psum the compiled graph breaks
    around), as the same body run eagerly does, within f32 rounding; the
    second call, with another float, reuses the ranks' compiled graphs."""
    def body(mesh, x, w, scale):
        return psum(x[mesh.rank] @ w * scale, "data", mesh)

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))
    world = rpex.pilot.world
    with _dfk(rpex):
        compiled = spmd_app(slots=2)(body)
        got = [compiled(x, w, s).result().fetch() for s in (1.0, 0.5)]
        graphs = [c["graphs"] for c in list(world.calls)[-2:]]
        eager = spmd_app(slots=2, jit=False)(body)(x, w, 1.0).result().fetch()
    assert graphs[0] >= 1 and graphs[1] == 0
    torch.testing.assert_close(got[0], eager, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[1], eager * 0.5, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(eager, x[0] @ w + x[1] @ w, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.timeout(120)
def test_block_state_outlives_cold_groups(rpex):
    """A block's ``mesh.state`` is kept by each rank per block, not with its
    cached groups: with the cache off (each task builds its block's groups
    and the ranks destroy them after it), what one task keeps there the
    next task on the block reads, in each rank."""
    def put(mesh, v):
        mesh.state["v"] = v + mesh.rank
        return 0

    def get(mesh):
        import torch.distributed as dist
        got = [None] * mesh.size
        dist.all_gather_object(got, mesh.state["v"], group=mesh.group())
        return got

    world = rpex.pilot.world
    world.run(put, (7,), {}, (0, 1), (2, 1), cache=False)
    assert world.run(get, (), {}, (0, 1), (2, 1), cache=False) == [7, 8]
    assert [c["built"] for c in list(world.calls)[-2:]] == [True, True]


def test_group_naming_hook_matches_torch():
    """The world names its groups through torch's private
    ``distributed_c10d._process_group_name(ranks, use_hashed_name)``,
    which ``new_group`` calls: fail here, at once, if torch changes
    either, rather than in a world whose ranks disagree on a name."""
    import inspect

    import torch.distributed.distributed_c10d as c10d
    assert list(inspect.signature(c10d._process_group_name).parameters) == [
        "ranks", "use_hashed_name"]
    assert "_process_group_name(" in inspect.getsource(
        c10d._new_group_with_tag)


def test_collectives_without_a_world():
    """In-process a SubMesh has no process group: on one device every
    collective is the identity; across two a collective raises, as does
    its DeviceMesh."""
    from repro_torch.core import SubMesh
    one = SubMesh([torch.device("cpu")], (1, 1))
    x = torch.arange(4.0)
    assert psum(x, "data", one) is x
    assert torch.equal(shard_map(lambda a: psum(a.sum(), "data"), one,
                                 P("data"), P())(x), x.sum())
    two = SubMesh([torch.device("cpu")] * 2, (2, 1))
    with pytest.raises(RuntimeError, match="no process group"):
        psum(x, "data", two)
    assert psum(x, "model", two) is x       # the model axis is one wide
    with pytest.raises(RuntimeError, match="no process group"):
        two.device_mesh


@pytest.mark.timeout(120)
def test_psum_over_each_axis_of_a_2x2_block(rpex):
    """A (2, 2) block: rank r holds x_r; psum over "data" adds the ranks of
    its column, over "model" those of its row, over both all four; pmean
    divides by the axis size; shard_map splits dim 0 over "data" and dim 1
    over "model" and gathers them back."""
    xs = np.random.default_rng(0).standard_normal((4, 3)).astype(np.float32)

    @spmd_app(slots=4, mesh=(2, 2), jit=False)
    def reduce(mesh, xs):
        x = xs[mesh.rank]
        out = {"data": psum(x, "data", mesh), "model": psum(x, "model", mesh),
               "both": psum(x, ("data", "model"), mesh),
               "mean": pmean(x, "model", mesh)}
        # every rank's value, rank by rank
        out = {k: all_gather(v[None], ("data", "model"), 0, mesh)
               for k, v in out.items()}
        grid = torch.arange(24.0).reshape(4, 6)
        out["grid"] = shard_map(lambda g: g * 2, mesh, P("data", "model"),
                                P("data", "model"))(grid)
        return out

    with _dfk(rpex):
        got = {k: v.fetch().numpy()
               for k, v in reduce(torch.from_numpy(xs)).result().items()}
    # ranks (0, 1, 2, 3) as a (2, 2) grid: data columns {0, 2} {1, 3},
    # model rows {0, 1} {2, 3}
    col = [0, 1, 0, 1]
    row = [0, 0, 1, 1]
    for r in range(4):
        np.testing.assert_allclose(
            got["data"][r], xs[[i for i in range(4) if col[i] == col[r]]]
            .sum(0), rtol=1e-6)
        np.testing.assert_allclose(
            got["model"][r], xs[[i for i in range(4) if row[i] == row[r]]]
            .sum(0), rtol=1e-6)
        np.testing.assert_allclose(got["both"][r], xs.sum(0), rtol=1e-6)
        np.testing.assert_allclose(
            got["mean"][r], xs[[i for i in range(4) if row[i] == row[r]]]
            .mean(0), rtol=1e-6)
    np.testing.assert_array_equal(got["grid"],
                                  np.arange(24.0).reshape(4, 6) * 2)


@pytest.mark.timeout(120)
def test_disjoint_blocks_run_at_once(rpex, tmp_path):
    """Two 2-slot tasks on disjoint blocks: each body writes its own file
    and waits for the other's, so both finish only if they overlap."""
    @spmd_app(slots=2, jit=False)
    def meet(mesh, me, other):
        import os
        import time
        if mesh.rank == 0:
            open(me, "w").close()
        deadline = time.monotonic() + 60
        while not os.path.exists(other):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{other} never appeared")
            time.sleep(0.01)
        return psum(torch.ones(()), "data", mesh).item()

    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    with _dfk(rpex):
        fa, fb = meet(a, b), meet(b, a)
        assert (fa.result(), fb.result()) == (2.0, 2.0)
    blocks = [tuple(sorted({s % 4 for s in f.task.slot_ids}))
              for f in (fa, fb)]
    assert not set(blocks[0]) & set(blocks[1])


@pytest.mark.timeout(120)
def test_overlapping_blocks_do_not_deadlock(rpex):
    """16 three-slot tasks on 8 slots over 4 ranks, each with a psum, all
    DONE; then 16 calls on the four rotating 3-rank blocks ({0,1,2},
    {1,2,3}, {0,2,3}, {0,1,3}) from 16 threads at once: every rank takes
    them in one global order, so no two wait on each other."""
    @spmd_app(slots=3, jit=False)
    def three(mesh, i):
        return float(psum(torch.tensor(float(i)), "data", mesh))

    with _dfk(rpex):
        futs = [three(i) for i in range(16)]
        assert [f.result() for f in futs] == [3.0 * i for i in range(16)]
    assert all(f.task.state == TaskState.DONE for f in futs)

    def body(mesh, i):
        return float(psum(torch.tensor(float(i)), "data", mesh))

    world = rpex.pilot.world
    blocks = [(0, 1, 2), (1, 2, 3), (0, 2, 3), (0, 1, 3)]
    out = [None] * 16

    def call(i):
        out[i] = world.run(body, (i,), {}, blocks[i % 4], (3, 1))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(16)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert out == [3.0 * i for i in range(16)]


@pytest.mark.timeout(120)
def test_rank_raising_before_a_collective(rpex):
    """Rank 1 raises before the psum its peers wait in: the task fails
    with rank 1's own traceback at once (the world is killed, not left to
    the timeout), and the next task runs on the restarted world."""
    @spmd_app(slots=4, jit=False)
    def bad(mesh):
        if mesh.rank == 1:
            raise ValueError(f"rank {mesh.rank} refuses")
        return psum(torch.ones(()), "data", mesh)

    @spmd_app(slots=4, jit=False)
    def good(mesh):
        return float(psum(torch.ones(()), "data", mesh))

    restarts = len(_events(rpex, EVENTS.WORLD_RESTART))
    t0 = time.monotonic()
    with _dfk(rpex):
        with pytest.raises(ValueError, match="rank 1 refuses") as err:
            bad().result()
        assert time.monotonic() - t0 < 30
        assert "raise ValueError" in err.value.remote_traceback
        assert good().result() == 4.0
    got = _events(rpex, EVENTS.WORLD_RESTART)
    assert len(got) == restarts + 1
    assert "rank 1 raised" in got[-1]["reason"]


@pytest.mark.timeout(120)
def test_rankref_stays_on_the_ranks(rpex):
    """A tensor result stays on its ranks: a later task on the same block
    takes its RankRef without a byte crossing, a Python task gets it on the
    host, a task on another block gets it by value, and the ranks drop it
    when the parent's last RankRef dies."""
    @spmd_app(slots=2, jit=False)
    def make(mesh):
        return {"w": torch.full((256, 256), float(mesh.rank + 1)),
                "tag": "made"}

    @spmd_app(slots=2, jit=False)
    def use(mesh, w):
        return float(psum(w.sum(), "data", mesh))

    @spmd_app(slots=4, jit=False)
    def use4(mesh, w):
        return float(psum(w.sum(), "data", mesh))

    @python_app
    def on_host(w):
        return (type(w).__name__, w.device.type, float(w[0, 0]))

    world = rpex.pilot.world
    with _dfk(rpex):
        made = make().result()
        ref = made["w"]
        assert made["tag"] == "made" and isinstance(ref, RankRef)
        assert ref.shape == (256, 256) and ref.dtype == torch.float32
        sent = world.stats["tensor_bytes_to_ranks"]
        back = world.stats["tensor_bytes_from_ranks"]
        # rank 0 holds ones, rank 1 twos: the sum is computed in place
        assert use(ref).result() == 3.0 * 256 * 256
        assert world.stats["tensor_bytes_to_ranks"] == sent
        assert world.stats["tensor_bytes_from_ranks"] == back
        assert on_host(ref).result() == ("Tensor", "cpu", 1.0)
        assert world.stats["tensor_bytes_from_ranks"] == back + 256 * 256 * 4
        # another block gets it by value: rank 0's tensor, sent to 4 ranks
        sent = world.stats["tensor_bytes_to_ranks"]
        assert use4(ref).result() == 4.0 * 256 * 256
        assert world.stats["tensor_bytes_to_ranks"] == sent + 4 * 256 * 256 * 4

    def held():
        world.run(lambda mesh: None, (), {}, (0, 1), (2, 1))
        return world.calls[-1]["held"]

    direct = world.run(make.__wrapped_app__, (), {}, (0, 1), (2, 1))
    before = held()
    del direct
    gc.collect()
    assert held() == before - 1


@pytest.mark.timeout(120)
def test_checkpointable_body_resumes_on_the_restarted_world(rpex, tmp_path):
    """A checkpointable spmd body on 2 ranks: the block's first rank sends
    each ``ckpt.save`` and both ranks wait for the parent to persist it;
    the first attempt raises after step 2, and the retry, on the restarted
    world, resumes from the persisted step 2."""
    flag = str(tmp_path / "failed_once")

    @spmd_app(slots=2, jit=False, checkpointable=True, retries=1)
    def steps(mesh, flag, ckpt=None):
        import os
        got = ckpt.restore()
        start = got[0] if got is not None else 0
        for s in range(start + 1, 5):
            total = float(psum(torch.tensor(float(s)), "data", mesh))
            ckpt.save(s, {"total": total})
            if s == 2 and not os.path.exists(flag):
                if mesh.rank == 0:
                    open(flag, "w").close()
                raise RuntimeError("fail after step 2")
        return start, total

    with _dfk(rpex):
        fut = steps(flag)
        assert fut.result() == (2, 8.0)
    assert "fail after step 2" in str(fut.task.attempt_errors[0])


@pytest.mark.timeout(120)
def test_ranks_load_no_jax_and_no_repro(rpex):
    """Every rank's ``sys.modules`` holds neither jax nor the reference
    package ``repro``, even with both loaded in the parent."""
    import jax  # noqa: F401 — loaded here on purpose

    @spmd_app(slots=4, jit=False)
    def modules(mesh):
        import sys
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "repro"))
        if bad:
            raise AssertionError(f"rank {mesh.rank} loaded {bad[:5]}")
        return bad

    with _dfk(rpex):
        assert modules().result() == []


@pytest.mark.timeout(120)
def test_killed_rank_gives_worker_died_and_the_retry_succeeds(tmp_path):
    """Rank 1 is SIGKILLed mid-body: the attempt fails with WorkerDied, the
    world restarts, and the retry runs to its end on the new ranks."""
    flag = str(tmp_path / "started")

    @spmd_app(slots=2, jit=False, retries=1)
    def slow(mesh, flag):
        import os
        import time
        if not os.path.exists(flag):
            if mesh.rank == 0:
                open(flag, "w").close()
            time.sleep(60)
        return float(psum(torch.ones(()), "data", mesh))

    ex = _rpex(n_slots=2, ranks=2)
    try:
        world = ex.pilot.world
        with DataFlowKernel(executors={"rpex": ex}):
            fut = slow(flag)
            deadline = time.monotonic() + 30
            while not os.path.exists(flag):
                assert time.monotonic() < deadline
                time.sleep(0.01)
            time.sleep(0.2)
            os.kill(world.pids()[1], signal.SIGKILL)
            assert fut.result(timeout=60) == 2.0
        assert isinstance(fut.task.attempt_errors[0], WorkerDied)
        assert world.stats["restarts"] == 1
    finally:
        ex.shutdown()
    # the world's journal events (read by prefix: the reference's event
    # checker scans this file too, and its registry has no world)
    world_kinds = [e["event"] for e in ex.pilot.store.events_snapshot()
                   if e["event"].startswith("WORLD_")]
    assert world_kinds == [EVENTS.WORLD_START, EVENTS.WORLD_RESTART,
                           EVENTS.WORLD_STOP]


@pytest.mark.timeout(120)
def test_all_gather_through_c10d_matches_the_functional_one():
    """Ranks sharing a card route DTensor's all-gathers through the c10d
    call (gloo's functional one crashes on CUDA tensors): on two CPU ranks
    the replacement gives what ``_functional_collectives.all_gather_tensor``
    gives, along dim 0 and 1, for a (mesh, dim) pair and a process group;
    and with it installed, a DTensor sharded on dim 1 (5 columns: uneven)
    gathers to its full value."""
    def body(mesh):
        import torch.distributed._functional_collectives as funcol
        from torch.distributed.tensor import Shard, distribute_tensor

        from repro_torch.core import spmd_world as W
        dm = mesh.device_mesh
        x = torch.arange(12.0).reshape(3, 4) + 100 * mesh.rank
        same = [torch.equal(W._c10d_all_gather(x, d, g),
                            funcol.all_gather_tensor(x, d, g) + 0)
                for d in (0, 1) for g in ((dm, 0), mesh.group("data"))]
        W._gather_through_c10d()
        full = torch.arange(20.0).reshape(4, 5)
        got = distribute_tensor(full, dm, [Shard(1), Shard(0)]).full_tensor()
        return same, torch.equal(got, full)

    ex = _rpex(n_slots=2, ranks=2)
    try:
        same, gathered = ex.pilot.world.run(body, (), {}, (0, 1), (2, 1))
    finally:
        ex.shutdown()
    assert same == [True] * 4 and gathered


@pytest.mark.timeout(120)
def test_rank_dying_inside_a_collective_gives_worker_died(tmp_path):
    """Rank 1 SIGKILLs itself while rank 0 waits for it in a psum: rank 0's
    gloo error and rank 1's death race to the parent, and the task fails
    with WorkerDied whichever comes first (the train driver's fault drill
    tells a dead rank from a raising body by it)."""
    @spmd_app(slots=2, jit=False)
    def die(mesh):
        import os
        import signal
        if mesh.rank == 1:
            os.kill(os.getpid(), signal.SIGKILL)
        return psum(torch.ones(()), "data", mesh)

    ex = _rpex(n_slots=2, ranks=2)
    try:
        with DataFlowKernel(executors={"rpex": ex}):
            with pytest.raises(WorkerDied):
                die().result(timeout=60)
    finally:
        ex.shutdown()


@pytest.mark.timeout(120)
@pytest.mark.parametrize("cache", [True, False], ids=["cached", "cold"])
def test_executable_cache_reuse(cache):
    """The reference's ``test_executable_cache_reuse`` on a 2-rank world
    (8 slots: every 2-slot block is ranks {0, 1}): cached, one
    specialization serves the 8 tasks (7 hits) and the ranks build the
    block's groups once; cold (the paper's cold-communicator ablation)
    every task specializes and builds its groups anew, under a new name
    each time that the block's ranks agree on, and the ranks destroy them
    after it: over 12 tasks a rank holds as many live groups in each (read
    from c10d's own registry), the groups of a DTensor result outliving
    its task until the result is dropped.  The results are the same
    either way, and a RankRef of a closed world raises."""
    @spmd_app(slots=2, jit=False)
    def t(mesh, x):
        return x * 2.0

    @spmd_app(slots=2, jit=False)
    def names(mesh, i):
        import torch.distributed as dist
        import torch.distributed.distributed_c10d as c10d
        seen = [None, None]
        dist.all_gather_object(seen, mesh.group().group_name,
                               group=mesh.group())
        return (seen, float(psum(torch.tensor(float(i)), "data", mesh)),
                len(c10d._world.pg_map))

    @spmd_app(slots=2, jit=False)
    def keep(mesh):
        return torch.ones(3)

    def spread(mesh):
        from torch.distributed.tensor import (Replicate, Shard,
                                              distribute_tensor)
        return distribute_tensor(torch.arange(4.0), mesh.device_mesh,
                                 [Shard(0), Replicate()])

    ex = _rpex(n_slots=8, ranks=2, cache_executables=cache)
    try:
        with DataFlowKernel(executors={"rpex": _Kept(ex)}):
            futs = [t(float(i)) for i in range(8)]
            assert [f.result() for f in futs] == [i * 2.0 for i in range(8)]
            stats = dict(ex.pilot.executor.stats)
            built = sum(c["built"] for c in ex.pilot.world.calls)
            got = [names(i).result() for i in range(12)]
            ref = keep().result()
            # called directly: a task's future would keep its RankRef
            dt = ex.pilot.world.run(spread, (), {}, (0, 1), (2, 1),
                                    cache=cache)
            held = names(12).result()[2]        # spread's groups still live
            assert torch.equal(dt.fetch(), torch.arange(4.0))
            del dt
            gc.collect()
            after = names(13).result()[2]
    finally:
        ex.shutdown()
    if cache:
        assert stats["compiles"] == 1 and stats["cache_hits"] >= 7
        assert built == 1
        assert len({seen[0] for seen, _, _ in got}) == 1
    else:
        assert stats["compiles"] == 8 and stats["cache_hits"] == 0
        assert built == 8
        assert len({seen[0] for seen, _, _ in got}) == 12
        assert held > after
    assert len({n for _, _, n in got}) == 1 and after == got[0][2]
    assert all(seen[0] == seen[1] for seen, _, _ in got)
    assert [v for _, v, _ in got] == [2.0 * i for i in range(12)]
    with pytest.raises(StaleRankRef):
        ref.fetch()


def _smollm_case():
    import dataclasses

    from repro_torch import configs as TC
    cfg = dataclasses.replace(TC.reduce_config(TC.get_config("smollm-360m")),
                              dtype="float32", num_layers=2)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
    mask = (rng.random((4, 16)) < 0.9).astype(np.float32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "targets": torch.from_numpy(toks[:, 1:].copy()),
             "loss_mask": torch.from_numpy(mask)}
    return cfg, batch


@pytest.mark.timeout(180)
def test_smollm_on_a_2x2_block_matches_unsharded(rpex):
    """Reduced smollm-360m at 2 layers (f32, B=4, S=16) on a (2, 2) block,
    through ``ShardCtx(mesh.device_mesh)`` and the sharded step factories:
    an init task leaves the params on the ranks as RankRefs (DTensors),
    then prefill, loss-and-grad and an AdamW step take them.  The prefill
    logits, the loss and every grad leaf match the unsharded port on the
    same params (within the bounds of test_torch_sharding's
    ``test_sharded_model_matches_unsharded``: loss 1e-5, each grad leaf
    1e-4 of its largest magnitude) and the step's loss and grad norm
    (``test_sharded_train_step_matches_unsharded``: 1e-5, rel 1e-5).  The
    stepped params, fetched, hold the step's update: each leaf's change
    within 5e-3 (normwise) of the unsharded step's change (measured at
    most 9.0e-4: the first step moves a param by ~3e-6, so one f32 ulp of
    a param of 0.02 is 6e-4 of it; an update lost reads 1)."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamW
    from repro_torch.tree import leaves

    cfg, batch = _smollm_case()

    @spmd_app(slots=4, mesh=(2, 2), jit=False)
    def init(mesh, cfg):
        from repro_torch import params as PP
        from repro_torch.models import transformer as TT
        from repro_torch.optim import AdamW as A
        params = PP.shard_tree(TT.init_params(cfg, 0, device=mesh.device),
                               cfg, mesh.device_mesh)
        return params, A().init(params)

    @spmd_app(slots=4, mesh=(2, 2), jit=False)
    def prefill(mesh, cfg, params, batch):
        from repro_torch.models import model as MM
        from repro_torch.sharding import ShardCtx
        logits, _ = MM.make_prefill_step(cfg, ShardCtx(mesh.device_mesh))(
            params, {"tokens": batch["tokens"]})
        return MM.full(logits)

    @spmd_app(slots=4, mesh=(2, 2), jit=False)
    def loss_and_grad(mesh, cfg, params, batch):
        from repro_torch.models import model as MM
        from repro_torch.sharding import ShardCtx
        grads, metrics = MM.make_loss_and_grad(
            cfg, ShardCtx(mesh.device_mesh))(params, batch)
        return grads, float(metrics["loss"])

    @spmd_app(slots=4, mesh=(2, 2), jit=False)
    def step(mesh, cfg, params, state, batch):
        from repro_torch.models import model as MM
        from repro_torch.optim import AdamW as A
        from repro_torch.sharding import ShardCtx
        params, state, metrics = MM.make_train_step(
            cfg, A(), ShardCtx(mesh.device_mesh))(params, state, batch)
        return params, state, {k: float(v) for k, v in metrics.items()}

    world = rpex.pilot.world
    with _dfk(rpex):
        params, state = init(cfg).result()
        assert all(isinstance(r, RankRef) and r.placement is not None
                   for r in leaves(params))
        sent = world.stats["tensor_bytes_to_ranks"]
        logits = prefill(cfg, params, batch).result().fetch()
        grads, loss = loss_and_grad(cfg, params, batch).result()
        new_params, _, metrics = step(cfg, params, state, batch).result()
        # only the batch crossed: the params stayed on the ranks
        batch_bytes = sum(t.nelement() * t.element_size()
                          for t in batch.values())
        assert world.stats["tensor_bytes_to_ranks"] - sent == (
            3 * 4 * batch_bytes)
        got_grads = [g.fetch() for g in leaves(grads)]
        got_params = leaves(fetch_refs(new_params))
    plain = T.init_params(cfg, 0, device="cpu")
    before = leaves(T.init_params(cfg, 0, device="cpu"))
    want_logits, _ = M.make_prefill_step(cfg)(plain,
                                              {"tokens": batch["tokens"]})
    np.testing.assert_allclose(logits.numpy(), want_logits.numpy(),
                               atol=1e-5, rtol=1e-5)
    want_grads, want_m = M.make_loss_and_grad(cfg)(plain, batch)
    assert abs(loss - float(want_m["loss"])) <= 1e-5
    for g, w in zip(got_grads, leaves(want_grads)):
        scale = float(w.abs().max()) or 1.0
        assert float((g - w).abs().max()) <= 1e-4 * scale
    opt = AdamW()
    _, _, want_step = M.make_train_step(cfg, opt)(plain, opt.init(plain),
                                                  batch)
    assert abs(metrics["loss"] - float(want_step["loss"])) <= 1e-5
    assert metrics["grad_norm"] == pytest.approx(
        float(want_step["grad_norm"]), rel=1e-5)
    assert all(isinstance(r, RankRef) for r in leaves(new_params))
    # the step's update itself, leaf by leaf, against the unsharded one
    for g, w, b in zip(got_params, leaves(plain), before):
        want_d, got_d = (w - b).double(), (g - b).double()
        assert float(want_d.norm()) > 0
        assert float((got_d - want_d).norm()) <= 5e-3 * float(want_d.norm())
