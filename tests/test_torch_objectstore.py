"""The data plane: ObjectStore refs, GC, spill, shm transport, and
byte-weighted affinity (docs/dataplane.md).

The hard invariants under test:
  * a published result travels as an ObjectRef and AppFuture.result()
    derefs it transparently (small results stay inline and lock-free);
  * ref-count GC fires exactly once per consumer edge, even when N
    consumers complete concurrently and callers double-release;
  * GC spills before dropping, and a cold deref round-trips from disk;
  * the journal records ref metadata (not the payload) and a restarted
    run re-materializes the result from the spill;
  * the proc transport's shm fast path round-trips large arrays and
    leaks no /dev/shm segment even when workers are SIGKILLed mid-run;
  * affinity_match/remote_bytes weight placement by input bytes, so a
    consumer with one large + many small inputs follows the large one
    (where uid counting picks the wrong pilot);
  * checkpoint pytree leaves dedupe against result spills (one blob).
"""
import concurrent.futures
import glob
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import (AppFuture, CostModelPolicy, DataFlowKernel,
                              FaultInjector, LocalityAware, ObjectRef, ObjectStore,
                              ResourceSpec, RPEXExecutor,
                              TaskRecord, affinity_match, python_app, remote_bytes)
from repro_torch.core import PilotDescription as _PilotDescription
from repro_torch.core.objectstore import estimate_size, materialize


def PilotDescription(*args, **kw):
    """The suite's pilot descriptions on the CPU, asked for explicitly: a
    description without devices means every CUDA device, and raises
    without a card."""
    kw.setdefault("devices", [torch.device("cpu")])
    return _PilotDescription(*args, **kw)


BIG = 256 * 1024        # comfortably above the 64 KiB publish threshold


def _reap_stale_shm():
    """Drop rpxshm segments a previous (crashed) run may have left so the
    no-leak assertions only see this test's segments."""
    for path in glob.glob("/dev/shm/rpxshm*"):
        try:
            os.unlink(path)
        except OSError:
            pass


def _arr(n=BIG // 8):
    return np.arange(n, dtype=np.float64)


# ------------------------------ store unit ------------------------------- #

def test_publish_threshold_and_transparent_deref():
    s = ObjectStore()
    small = s.maybe_publish([1, 2, 3], owner="p0")
    assert small == [1, 2, 3]               # inline: below threshold
    ref = s.maybe_publish(_arr(), owner="p0")
    assert isinstance(ref, ObjectRef)
    assert ref.size == BIG and ref.pilot_uid == "p0"
    assert "ndarray" in ref.kind

    # AppFuture deref is transparent and cached
    f = AppFuture(TaskRecord(uid="t", kind="python", fn=None))
    f.set_result(ref)
    got = f.result()
    assert np.array_equal(got, _arr())
    assert f.quick_result() is got          # cached after first deref
    # inline values keep the lock-free fast path
    f2 = AppFuture(TaskRecord(uid="t2", kind="python", fn=None))
    f2.set_result(41)
    assert f2.quick_result() == 41


def test_same_pilot_deref_is_zero_copy_and_uncounted():
    s = ObjectStore()
    a = _arr()
    ref = s.publish(a, owner="p0")
    assert s.get(ref, pilot_uid="p0") is a  # the very same object
    assert s.stats()["bytes_moved"] == 0
    # cross-pilot: counted once per (object, pilot), not per deref
    s.get(ref, pilot_uid="p1")
    s.get(ref, pilot_uid="p1")
    assert s.stats()["bytes_moved"] == BIG
    s.get(ref, pilot_uid="p2")
    assert s.stats()["bytes_moved"] == 2 * BIG


def test_gc_exactly_once_under_concurrent_release(tmp_path):
    s = ObjectStore(spill_dir=str(tmp_path / "obj"))
    ref = s.publish(_arr(), owner="p0")
    n = 16
    s.add_consumers(ref.oid, n)
    barrier = threading.Barrier(n)

    def consumer():
        barrier.wait()
        s.release(ref.oid)
        s.release(ref.oid)              # double-release must be ignored

    ts = [threading.Thread(target=consumer) for _ in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    e = s.entry(ref.oid)
    assert e.consumers == 0
    assert e.dropped                    # GC'd exactly at zero, not before
    assert s.stats()["spills"] == 1     # spilled once, not per release
    # cold deref re-materializes from the spill
    got = s.get(ref, pilot_uid="p1")
    assert np.array_equal(got, _arr())


def test_spill_round_trip_and_content_dedupe(tmp_path):
    s = ObjectStore(spill_dir=str(tmp_path / "obj"))
    a = _arr()
    r1 = s.publish(a, owner="p0")
    r2 = s.publish(a.copy(), owner="p1")    # byte-identical payload
    s.ensure_spilled(r1.oid)
    s.ensure_spilled(r2.oid)
    assert s.ensure_spilled(r1.oid) == s.ensure_spilled(r2.oid)  # same sha
    blobs = glob.glob(str(tmp_path / "obj" / "blob_*.pkl"))
    assert len(blobs) == 1              # content-addressed: one blob
    assert s.stats()["spills"] == 1


def test_published_tensor_mutated_in_place_fails_on_deref():
    """A tensor has no read-only flag, so the store guards a published
    tensor by its in-place version counter: after a write, a deref raises
    (an ndarray raises already at the write, frozen on publish)."""
    s = ObjectStore()
    t = torch.arange(BIG // 4, dtype=torch.float32)
    ref = s.maybe_publish(t, owner="p0")
    assert isinstance(ref, ObjectRef) and ref.size == BIG
    assert s.get(ref, pilot_uid="p0") is t  # zero-copy while untouched
    assert s.get(ref, pilot_uid="p1") is t
    t.add_(1.0)
    with pytest.raises(ValueError, match="modified in place"):
        s.get(ref, pilot_uid="p0")


def test_published_tensor_reloaded_from_spill_is_guarded(tmp_path):
    s = ObjectStore(spill_dir=str(tmp_path / "obj"))
    ref = s.publish(torch.ones(BIG // 4), owner="p0")
    s.add_consumers(ref.oid)
    s.release(ref.oid)                      # GC: spilled and dropped
    assert s.entry(ref.oid).dropped
    back = s.get(ref, pilot_uid="p0")
    assert isinstance(back, torch.Tensor) and torch.equal(
        back, torch.ones(BIG // 4))
    assert s.get(ref, pilot_uid="p0") is back
    back.mul_(2.0)
    with pytest.raises(ValueError, match="modified in place"):
        s.get(ref, pilot_uid="p0")


def test_rehost_moves_ownership():
    s = ObjectStore()
    ref = s.publish(_arr(), owner="dead")
    s.get(ref, pilot_uid="live")        # cached on the survivor
    assert s.stats()["bytes_moved"] == BIG
    assert s.rehost("dead", "live") == 1
    e = s.entry(ref.oid)
    assert e.owner == "live"
    # survivor reads are local now; no fresh transfer charge
    s.get(ref, pilot_uid="live")
    assert s.stats()["bytes_moved"] == BIG


def test_materialize_preserves_structure():
    s = ObjectStore()
    ref = s.publish(_arr(), owner="p0")
    args = (1, [ref, 2], {"x": ref})
    out = materialize(args, s)
    assert out[0] == 1
    assert np.array_equal(out[1][0], _arr())
    assert np.array_equal(out[2]["x"], _arr())
    # no refs -> identity (no rebuild on the hot path)
    plain = (1, [2, 3], {"x": 4})
    assert materialize(plain, s) is plain


def test_estimate_size_is_cheap_and_sane():
    assert estimate_size(_arr()) == BIG
    assert estimate_size(b"abcd") == 4
    assert estimate_size({"a": _arr(), "b": 1}) >= BIG
    assert estimate_size(object()) == 32


# --------------------------- end-to-end spine ---------------------------- #

@python_app
def _produce():
    return np.ones(BIG // 8, dtype=np.float64)


@python_app
def _consume(x):
    return float(x.sum())


@pytest.mark.timeout(60)
def test_dfk_edge_bytes_and_release_on_done():
    ex = RPEXExecutor(PilotDescription(name="p0", n_slots=2))
    with DataFlowKernel(executors={"rpex": ex}) as dfk:
        f = _produce()
        g = _consume(f)
        assert g.result() == float(BIG // 8)
        ref = f.raw_result()
        assert isinstance(ref, ObjectRef)
        # per-edge byte accounting
        assert dfk.edge_bytes_total == BIG
        (prod, cons, nbytes), = dfk.edge_bytes
        assert nbytes == BIG
        # the consumer's DONE released the only edge: GC spilled + dropped
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            e = ex.objectstore.entry(ref.oid)
            if e.dropped:
                break
            time.sleep(0.01)
        assert e.dropped
        # the producer's future still resolves (re-materialized)
        assert float(f.result().sum()) == float(BIG // 8)


@pytest.mark.timeout(60)
def test_ref_survives_journal_replay(tmp_path):
    j = str(tmp_path / "pilot.jsonl")

    def run():
        ex = RPEXExecutor(PilotDescription(name="p0", n_slots=2, journal=j))
        with DataFlowKernel(executors={"rpex": ex}, run_id="rr") as dfk:
            return _produce().result(), ex
    v1, ex1 = run()
    # journal line carries ref metadata, never the payload
    with open(j) as fh:
        done = [ln for ln in fh if '"result_ref"' in ln]
    assert done and all('"oid"' in ln for ln in done)
    # the payload is durable next to the journal
    assert glob.glob(str(tmp_path / "pilot.jsonl.obj" / "blob_*.pkl"))
    v2, ex2 = run()                       # restart: replay, no re-execute
    assert np.array_equal(v1, v2)
    assert ex2.pool.pilots[0].store.tasks.keys()  # replayed records exist


# ------------------------------ shm transport ---------------------------- #

@python_app
def _proc_double(a):
    return a * 2.0


@pytest.mark.timeout(120)
def test_shm_round_trip_and_no_leak():
    _reap_stale_shm()
    desc = PilotDescription(name="pp", n_slots=2, transport="proc",
                            shm_threshold=64 * 1024)
    ex = RPEXExecutor(desc)
    with DataFlowKernel(executors={"rpex": ex}):
        a = np.arange(BIG // 8, dtype=np.float64)
        out = _proc_double(a).result()
        assert np.array_equal(out, a * 2.0)
    if os.path.isdir("/dev/shm"):
        assert glob.glob("/dev/shm/rpxshm*") == []


@python_app
def _proc_tensor(t):
    assert isinstance(t, torch.Tensor)
    t.mul_(0.0)         # a write to a shm-mapped tensor stays in the child
    return t + 1.0


@pytest.mark.timeout(120)
def test_shm_carries_cpu_tensors_both_ways(monkeypatch):
    """A large contiguous CPU tensor crosses the proc boundary through a
    shared-memory segment (its .numpy() view) both as an argument and as
    a result, and arrives as a tensor; the body may write to its copy."""
    from repro_torch.core import transport
    parked, attached = [], []
    park, attach = transport._shm_park, transport._shm_attach
    monkeypatch.setattr(transport, "_shm_park",
                        lambda *a, **k: parked.append(1) or park(*a, **k))
    monkeypatch.setattr(transport, "_shm_attach",
                        lambda *a, **k: attached.append(1) or attach(*a, **k))
    _reap_stale_shm()
    desc = PilotDescription(name="pt", n_slots=2, transport="proc",
                            shm_threshold=64 * 1024)
    ex = RPEXExecutor(desc)
    # 128 KiB in 16384 elements: under torch's parallel grain in the child
    t = torch.arange(BIG // 16, dtype=torch.float64)
    with DataFlowKernel(executors={"rpex": ex}):
        out = _proc_tensor(t).result()
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float64
    assert torch.equal(out, torch.ones(BIG // 16, dtype=torch.float64))
    assert torch.equal(t, torch.arange(BIG // 16, dtype=torch.float64))
    assert parked == [1] and attached == [1]   # argument in, result out
    if os.path.isdir("/dev/shm"):
        assert glob.glob("/dev/shm/rpxshm*") == []


@python_app(retries=3)
def _slow_big(a):
    time.sleep(0.3)
    return a + 1.0


@pytest.mark.timeout(120)
def test_shm_cleanup_after_worker_sigkill():
    """FaultInjector SIGKILLs proc workers mid-run: tasks retry and
    finish, and no shm segment outlives the pool."""
    _reap_stale_shm()
    desc = PilotDescription(name="pk", n_slots=2, transport="proc",
                            shm_threshold=64 * 1024)
    ex = RPEXExecutor(desc, steal=False)
    pool = ex.pool
    inj = FaultInjector(pool, seed=3)
    inj.add_worker_kill(at_s=0.15)
    inj.add_worker_kill(at_s=0.45)
    with DataFlowKernel(executors={"rpex": ex}):
        a = np.arange(BIG // 8, dtype=np.float64)
        inj.start()
        futs = [_slow_big(a) for _ in range(4)]
        for f in futs:
            assert np.array_equal(f.result(), a + 1.0)
        inj.stop()
    assert any(e["kind"] == "worker-kill" and "pid" in e
               for e in inj.events)
    if os.path.isdir("/dev/shm"):
        assert glob.glob("/dev/shm/rpxshm*") == []


# ------------------------- byte-weighted affinity ------------------------ #

def _task_with_bytes(ab):
    t = TaskRecord(uid="t", kind="python", fn=None)
    t.affinity = tuple(ab)
    t.affinity_bytes = dict(ab)
    return t


class _FakePilot:
    def __init__(self, uid, name=None):
        self.uid = uid
        self.desc = type("D", (), {"name": name or uid})()


def test_affinity_match_weights_by_bytes():
    big, small = _FakePilot("pB"), _FakePilot("pS")
    t = _task_with_bytes({"pB": 8 * 1024 * 1024, "pS": 512})
    assert affinity_match(t, big) > 0.99
    assert affinity_match(t, small) < 0.01
    assert remote_bytes(t, big) == 512
    assert remote_bytes(t, small) == 8 * 1024 * 1024
    # legacy uid counting ties them at 0.5 each
    t.affinity_bytes = None
    assert affinity_match(t, big) == affinity_match(t, small) == 0.5


def test_cost_model_prices_transfer_seconds():
    pol = CostModelPolicy(inner=LocalityAware(),
                          bandwidth_bytes_s=1e6)   # 1 MB/s: huge penalty
    t = _task_with_bytes({"pB": 10_000_000, "pS": 100})
    assert remote_bytes(t, _FakePilot("pS")) / pol.bandwidth_bytes_s == \
        pytest.approx(10.0)
    with pytest.raises(ValueError):
        CostModelPolicy(bandwidth_bytes_s=0.0)


@python_app
def _big_producer():
    return np.ones(512 * 1024 // 8, dtype=np.float64)     # 512 KiB


@python_app
def _small_producer():
    return np.ones(65_536 // 8, dtype=np.float64)         # 64 KiB (published)


@python_app
def _sink(big, *smalls):
    return float(big.sum()) + sum(float(s.sum()) for s in smalls)


def _placement_run(byte_affinity: bool):
    """One large producer pinned on p1, three small ones pinned on p0; the
    consumer should follow the bytes (p1) — uid counting follows the
    count (p0)."""
    ex = RPEXExecutor([PilotDescription(name="p0", n_slots=4),
                       PilotDescription(name="p1", n_slots=4)],
                      steal=False,
                      placement=LocalityAware(locality_weight=10.0))
    res_p0 = ResourceSpec(slots=1, cpu_only=True, sticky=True,
                          affinity=("p0",))
    res_p1 = ResourceSpec(slots=1, cpu_only=True, sticky=True,
                          affinity=("p1",))
    with DataFlowKernel(executors={"rpex": ex},
                        byte_affinity=byte_affinity) as dfk:
        smalls = [dfk.submit(_small_producer.__wrapped_app__, (),
                             resources=res_p0) for _ in range(3)]
        big = dfk.submit(_big_producer.__wrapped_app__, (),
                         resources=res_p1)
        # drain producers fully so the sink routes against idle, equal
        # loads — the affinity term alone decides
        concurrent.futures.wait(smalls + [big])
        ex.drain(timeout=10.0)
        sink = dfk.submit(_sink.__wrapped_app__, (big, *smalls))
        sink.result()
        return sink.task.pilot_uid, {p.desc.name: p.uid
                                     for p in ex.pool.pilots}


@pytest.mark.timeout(120)
def test_byte_weighted_placement_follows_largest_input():
    uid, pilots = _placement_run(byte_affinity=True)
    assert uid == pilots["p1"]          # follows the 512 KiB input
    uid, pilots = _placement_run(byte_affinity=False)
    assert uid == pilots["p0"]          # uid counting: 3 hints beat 1


# --------------------------- checkpoint dedupe --------------------------- #

@pytest.mark.timeout(60)
def test_checkpoint_leaf_dedupes_against_result_spill(tmp_path):
    j = str(tmp_path / "c.jsonl")

    @python_app(checkpointable=True)
    def work(ckpt=None):
        state = np.ones(BIG // 8, dtype=np.float64)
        ckpt.save(0, state)             # leaf == the final result
        return state

    ex = RPEXExecutor(PilotDescription(name="c", n_slots=2, journal=j))
    with DataFlowKernel(executors={"rpex": ex}, run_id="cd") as dfk:
        out = work().result()
        assert float(out.sum()) == float(BIG // 8)
        # force the result spill through the journal writer
        assert ex.pool.pilots[0].store.flush()
    blobs = glob.glob(str(tmp_path / "c.jsonl.obj" / "blob_*.pkl"))
    # checkpoint leaf and spilled result are byte-identical -> one blob
    assert len(blobs) == 1
