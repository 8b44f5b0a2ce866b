"""Cost-model scheduling: the StateStore duration model (EWMA mean/var
per app kind, journal replay + compaction round-trip, cold-start
fallback), CostModelPolicy's predicted-seconds decisions, the agents'
per-kind straggler deadlines (the mixed-kind regression), and the
predictive PoolScaler/seeding plumbing."""
import json
import threading
import time

import pytest
import torch

from repro_torch.core import (CostModelPolicy, LeastLoaded, LocalityAware,
                              Pilot, PilotPool, PoolScaler,
                              ResourceSpec, ScalerConfig, StateStore, TaskRecord,
                              model_kind, resolve_policy, translate)
from repro_torch.core import PilotDescription as _PilotDescription


def PilotDescription(*args, **kw):
    """The suite's pilot descriptions on the CPU, asked for explicitly: a
    description without devices means every CUDA device, and raises
    without a card."""
    kw.setdefault("devices", [torch.device("cpu")])
    return _PilotDescription(*args, **kw)


def _ewma_ref(xs, alpha=0.2):
    """Offline reference for the store's West EWMA recurrence."""
    mean, var = xs[0], 0.0
    for x in xs[1:]:
        d = x - mean
        incr = alpha * d
        mean += incr
        var = (1.0 - alpha) * (var + d * incr)
    return mean, var, len(xs)


def _write_journal(path, task_timelines):
    """Synthetic journal: one line per transition with controlled
    monotonic stamps, exactly as record() lays them down.  Each timeline
    is (uid, kind, akind, [(state, mt), ...])."""
    off = time.time() - time.monotonic()
    with open(path, "w") as fh:
        for uid, kind, akind, steps in task_timelines:
            for state, mt in steps:
                rec = {"uid": uid, "key": None, "kind": kind,
                       "state": state, "retries": 0, "slot_ids": [0],
                       "t": mt + off, "mt": mt}
                if akind is not None:
                    rec["akind"] = akind
                fh.write(json.dumps(rec) + "\n")


# --------------------------- duration model ------------------------------ #

def test_ewma_incremental_matches_offline_reference():
    st = StateStore()
    xs = [1.0, 2.0, 4.0, 0.5, 3.0]
    with st._lock:
        for x in xs:
            st._dur_update("k", x)
    mean, var, n = st.duration_stats("k")
    rm, rv, rn = _ewma_ref(xs)
    assert (mean, n) == (pytest.approx(rm), rn)
    assert var == pytest.approx(rv)


def test_replay_rebuilds_model_from_running_done_stamps(tmp_path):
    """Journal replay feeds the model the same RUNNING->DONE samples the
    live _ingest path saw: controlled stamps give exact durations."""
    j = tmp_path / "j.jsonl"
    base = time.monotonic()
    tls = []
    durs = [1.0, 2.0, 4.0]
    for i, d in enumerate(durs):
        t0 = base + i * 10
        tls.append((f"t.{i}", "python", None,
                    [("SCHEDULED", t0 - 0.01), ("RUNNING", t0),
                     ("DONE", t0 + d)]))
    # a bash app executes as kind "python" but models under its app kind
    tls.append(("t.b", "python", "bash",
                [("RUNNING", base + 100), ("DONE", base + 100.5)]))
    # FAILED leaves no sample; the retry measures from its *latest*
    # RUNNING stamp, not the first
    tls.append(("t.r", "python", None,
                [("RUNNING", base + 200), ("FAILED", base + 209),
                 ("RUNNING", base + 210), ("DONE", base + 211.5)]))
    _write_journal(j, tls)
    st = StateStore(str(j))
    try:
        rm, rv, rn = _ewma_ref(durs + [1.5])      # t.r contributes 1.5s
        mean, var, n = st.duration_stats("python")
        assert n == rn
        assert mean == pytest.approx(rm)
        assert var == pytest.approx(rv)
        assert st.duration_stats("bash") == (pytest.approx(0.5), 0.0, 1)
    finally:
        st.close()


def test_compaction_snapshots_and_reseeds_model(tmp_path):
    """The model survives journal compaction via the stats header, and a
    restart on the compacted journal merges it back losslessly."""
    j = tmp_path / "j.jsonl"
    st = StateStore(str(j), compact_min_lines=4, compact_factor=1)
    st.seed_durations("spmd", 2.0, 0.25, 8)
    st.seed_durations("bash", 0.1, 0.0, 3)
    # enough non-sampling transitions to trip compaction (no RUNNING->DONE
    # pairs, so the model stays exactly the seeded values)
    for i in range(16):
        t = TaskRecord(uid=f"t.{i}", kind="python")
        from repro_torch.core import TaskState
        t.transition(TaskState.TRANSLATED, st)
        t.transition(TaskState.SCHEDULED, st)
    assert st.flush(timeout=10.0)
    st.close()
    txt = j.read_text().splitlines()
    head = json.loads(txt[0])
    assert head.get("event") == "_SNAPSHOT"
    assert head["stats"]["dur"]["spmd"] == [2.0, 0.25, 8]

    st2 = StateStore(str(j))
    try:
        assert st2.duration_stats("spmd") == (2.0, 0.25, 8)
        assert st2.duration_stats("bash") == (0.1, 0.0, 3)
    finally:
        st2.close()


def test_cold_start_returns_none_and_pooled_mixture():
    st = StateStore()
    assert st.duration_stats("anything") is None
    assert st.duration_stats(None) is None
    assert st.duration_model() == {}
    st.seed_durations("a", 1.0, 0.0, 1)
    st.seed_durations("b", 3.0, 0.0, 3)
    mean, var, n = st.duration_stats(None)      # n-weighted pool
    assert n == 4
    assert mean == pytest.approx((1.0 + 3.0 * 3) / 4)
    assert var == pytest.approx((1 * (2.5 - 1.0) ** 2
                                 + 3 * (2.5 - 3.0) ** 2) / 4 + 0.0)
    assert st.duration_stats("a") == (1.0, 0.0, 1)


def test_seed_durations_merges_n_weighted():
    st = StateStore()
    st.seed_durations("k", 1.0, 0.0, 2)
    st.seed_durations("k", 3.0, 0.0, 2)
    mean, var, n = st.duration_stats("k")
    assert (mean, n) == (2.0, 4)
    assert var == pytest.approx(1.0)            # between-source spread kept


# ------------------------- CostModelPolicy ------------------------------- #

def _kinded(name, body=None):
    fn = body or (lambda: 1)
    fn.__app_kind__ = name
    return fn


def _translate_kind(kind, **res):
    t = translate(_kinded(kind), (), {},
                  ResourceSpec(**res) if res else None)
    return t


def test_resolve_cost_policy_names_and_validation():
    p = resolve_policy("cost")
    assert isinstance(p, CostModelPolicy)
    assert isinstance(p.inner, LeastLoaded)
    p2 = CostModelPolicy(inner="locality")
    assert isinstance(p2.inner, LocalityAware)
    with pytest.raises(ValueError, match="wrap itself"):
        CostModelPolicy(inner=CostModelPolicy())
    with pytest.raises(ValueError, match="default_duration_s"):
        CostModelPolicy(default_duration_s=0.0)


def test_cold_model_degenerates_to_count_based_ranking():
    """With no samples anywhere, every pilot prices at the constant
    default and the cost ranking equals LeastLoaded's."""
    pool = PilotPool([PilotDescription(n_slots=2, name="a"),
                      PilotDescription(n_slots=2, name="b")],
                     steal=False, policy=CostModelPolicy())
    try:
        gate = threading.Event()
        a, b = pool.pilots
        for _ in range(3):              # load a: 3 gated blockers
            a.agent.submit(translate(lambda: gate.wait(15), (), {}))
        probe = translate(lambda: 1, (), {})
        assert pool.route(probe) is b   # least loaded, priced constant
        gate.set()
    finally:
        gate.set()
        pool.close()


def test_place_prefers_fewer_predicted_seconds_over_fewer_slots():
    """Two queued long tasks must repel a probe harder than four queued
    short ones — the core slot-count-vs-seconds inversion."""
    pool = PilotPool([PilotDescription(n_slots=1, name="a"),
                      PilotDescription(n_slots=1, name="b")],
                     steal=False, preempt=False, policy=CostModelPolicy())
    try:
        a, b = pool.pilots
        for p in (a, b):
            p.store.seed_durations("long", 5.0, 0.0, 10)
            p.store.seed_durations("short", 0.01, 0.0, 10)
            p.store.seed_durations("probe", 0.01, 0.0, 10)
        gate = threading.Event()
        for _ in range(2):              # a: ~10s of predicted backlog
            a.agent.submit(translate(
                _kinded("long", lambda: gate.wait(15)), (), {}))
        for _ in range(4):              # b: ~0.04s predicted, 2x the slots
            b.agent.submit(translate(
                _kinded("short", lambda: gate.wait(15)), (), {}))
        time.sleep(0.05)
        probe = _translate_kind("probe")
        assert pool.route(probe) is b                    # cost: pick b
        assert LeastLoaded().place(probe, [a, b]) is a   # counts: pick a
        gate.set()
    finally:
        gate.set()
        pool.close()


def test_place_bulk_accumulates_batch_seconds():
    """Bulk placement spreads by predicted seconds: after a long task
    lands on the emptier pilot, the next long task must go to the other
    one even though the first pilot still has fewer queued slots."""
    pool = PilotPool([PilotDescription(n_slots=1, name="a"),
                      PilotDescription(n_slots=1, name="b")],
                     steal=False, preempt=False, policy=CostModelPolicy())
    try:
        a, b = pool.pilots
        for p in (a, b):
            p.store.seed_durations("long", 5.0, 0.0, 10)
        tasks = [_translate_kind("long") for _ in range(4)]
        got = pool.route_bulk(tasks)
        assert {g.uid for g in got[:2]} == {a.uid, b.uid}   # alternates
        assert {g.uid for g in got[2:]} == {a.uid, b.uid}
    finally:
        pool.close()


def test_pick_victim_orders_by_backlog_seconds():
    pool = PilotPool([PilotDescription(n_slots=1, name="thief"),
                      PilotDescription(n_slots=1, name="a"),
                      PilotDescription(n_slots=1, name="b")],
                     steal=False, preempt=False, policy=CostModelPolicy())
    try:
        thief, a, b = pool.pilots
        for p in (a, b):
            p.store.seed_durations("long", 5.0, 0.0, 10)
            p.store.seed_durations("short", 0.01, 0.0, 10)
        gate = threading.Event()
        for _ in range(2):
            a.agent.submit(translate(
                _kinded("long", lambda: gate.wait(15)), (), {}))
        for _ in range(5):
            b.agent.submit(translate(
                _kinded("short", lambda: gate.wait(15)), (), {}))
        time.sleep(0.05)
        demand = {a.uid: a.agent.queued_demand(),
                  b.uid: b.agent.queued_demand()}
        assert demand[b.uid] > demand[a.uid]    # counts say b first
        order = pool.policy.pick_victim(thief, [a, b], demand)
        assert order[0] is a                    # seconds say a first
        gate.set()
    finally:
        gate.set()
        pool.close()


def test_steal_eligibility_prices_affinity_in_seconds():
    policy = CostModelPolicy(inner=LocalityAware(locality_weight=0.5))
    pool = PilotPool([PilotDescription(n_slots=1, name="thief"),
                      PilotDescription(n_slots=1, name="victim")],
                     steal=False, preempt=False, policy=policy)
    try:
        thief, victim = pool.pilots
        victim.store.seed_durations("long", 10.0, 0.0, 10)
        task = _translate_kind("long")
        task.affinity = (victim.uid,)
        # penalty = 0.5 weight * 10s run * 1.0 affinity lost = 5s; an
        # imbalance worth < 5s of victim backlog must not move the task
        assert not policy.steal_eligible(task, thief, victim,
                                         imbalance=0.4)   # 0.4*10s = 4s
        assert policy.steal_eligible(task, thief, victim,
                                     imbalance=0.6)       # 6s > 5s
        # a task with no affinity always moves (penalty <= 0)
        free = _translate_kind("long")
        assert policy.steal_eligible(free, thief, victim, imbalance=0.0)
    finally:
        pool.close()


def test_pick_preempt_spares_nearly_done_task():
    """The default policy preempts the longest-running task — exactly
    the one about to finish.  The cost model ranks by predicted
    *remaining* seconds, so the fresh task is the victim instead."""
    policy = CostModelPolicy()
    pool = PilotPool([PilotDescription(n_slots=2, name="thief"),
                      PilotDescription(n_slots=2, name="victim")],
                     steal=False, preempt=False, policy=policy)
    try:
        thief, victim = pool.pilots
        victim.store.seed_durations("work", 10.0, 0.0, 10)
        now = time.monotonic()
        nearly_done = _translate_kind("work")
        nearly_done.timestamps["RUNNING"] = now - 9.0     # 1s remaining
        fresh = _translate_kind("work")
        fresh.timestamps["RUNNING"] = now - 1.0           # 9s remaining
        cands = [(nearly_done, victim), (fresh, victim)]
        loads = {victim.uid: 1.0}
        got, _ = policy.pick_preempt(thief, cands, loads)
        assert got is fresh
        base, _ = LeastLoaded().pick_preempt(thief, cands, loads)
        assert base is nearly_done      # the inversion being fixed
    finally:
        pool.close()


# ---------------------- per-kind straggler deadlines --------------------- #

def _mk_pilot(per_kind=True, **kw):
    return Pilot(PilotDescription(n_slots=2, per_kind_deadlines=per_kind,
                                  **kw))


def test_per_kind_deadline_uses_kind_model():
    p = _mk_pilot(straggler_factor=3.0, straggler_stdev_k=4.0)
    try:
        p.store.seed_durations("slow", 2.0, 0.04, 10)
        dl = p.agent._deadline("slow")
        assert dl == pytest.approx(max(0.1, 6.0, 2.0 + 4.0 * 0.2))
        # a cold kind falls back to the global path (None: no samples)
        assert p.agent._deadline("never-seen") is None
    finally:
        p.close()


def test_per_kind_deadline_disabled_ignores_model():
    p = _mk_pilot(per_kind=False)
    try:
        p.store.seed_durations("slow", 2.0, 0.0, 10)
        assert p.agent._deadline("slow") is None    # global deque is cold
    finally:
        p.close()


def _run_mixed_kind_straggler(per_kind: bool) -> int:
    """Flood a fast kind to drag the global p95 to the floor, then run
    one normal slow-kind task; return how many replicas spawned."""
    p = Pilot(PilotDescription(n_slots=2, per_kind_deadlines=per_kind,
                              straggler_factor=3.0))
    try:
        # the slow kind's population is well-known: mean 0.15s
        p.store.seed_durations("slow", 0.15, 1e-6, 10)
        done = threading.Event()
        n_fast = 60
        left = [n_fast]
        lock = threading.Lock()

        def _one_done(t):
            with lock:
                left[0] -= 1
                if left[0] == 0:
                    done.set()
        for _ in range(n_fast):         # global p95 -> ~2ms * 3 (floored)
            p.agent.submit(translate(
                _kinded("fast", lambda: time.sleep(0.002)), (), {}),
                done_cb=_one_done)
        assert done.wait(30)
        probe_done = threading.Event()
        probe = translate(
            _kinded("slow", lambda: time.sleep(0.3)), (), {})
        p.agent.submit(probe, done_cb=lambda t: probe_done.set())
        assert probe_done.wait(30)
        time.sleep(0.1)                 # let any late monitor tick land
        return sum(1 for uid in p.store.states()
                   if uid.startswith("replica."))
    finally:
        p.close()


@pytest.mark.timeout(120)
def test_mixed_kind_flood_spawns_no_spurious_replicas():
    """The tentpole regression: a fast kind's flood drags the global p95
    below a slow kind's normal runtime.  Per-kind deadlines judge the
    slow task against its own population (0.45s deadline vs 0.3s run: no
    replica); the old global path replicates it spuriously."""
    assert _run_mixed_kind_straggler(per_kind=True) == 0


@pytest.mark.timeout(120)
def test_mixed_kind_flood_global_baseline_still_replicates():
    """Pin the bug the per-kind fix removes: with per_kind_deadlines off
    the same scenario must still spawn a spurious replica — if this ever
    stops failing-by-design, the regression test above has lost its
    discriminating power."""
    assert _run_mixed_kind_straggler(per_kind=False) >= 1


# -------------------- predictive scaling + seeding ----------------------- #

def test_predicted_queue_wait_prices_queued_kinds():
    p = Pilot(PilotDescription(n_slots=2))
    try:
        assert p.predicted_queue_wait() == 0.0
        p.store.seed_durations("slow", 2.0, 0.0, 10)
        gate = threading.Event()
        for _ in range(6):              # 2 run, 4 queue
            p.agent.submit(translate(
                _kinded("slow", lambda: gate.wait(15)), (), {}))
        time.sleep(0.05)
        queued = sum(p.agent.queued_by_kind().values())
        assert queued == 4
        assert p.predicted_queue_wait() == pytest.approx(
            queued * 2.0 / 2, rel=1e-6)
        gate.set()
    finally:
        gate.set()
        p.close()


def test_scaler_wait_signal_predictive_vs_observed():
    pool = PilotPool([PilotDescription(n_slots=1)], steal=False,
                     preempt=False)
    try:
        p = pool.pilots[0]
        p.store.seed_durations("slow", 3.0, 0.0, 10)
        gate = threading.Event()
        for _ in range(3):              # 1 runs, 2 queue: 6s predicted
            p.agent.submit(translate(
                _kinded("slow", lambda: gate.wait(15)), (), {}))
        time.sleep(0.05)
        now = time.monotonic()
        on = PoolScaler(pool, ScalerConfig(predictive=True))
        off = PoolScaler(pool, ScalerConfig(predictive=False))
        assert on._wait_signal(p, now) >= 6.0 - 1e-6
        assert off._wait_signal(p, now) < 1.0     # observed wait only
        gate.set()
    finally:
        gate.set()
        pool.close()


def test_add_pilot_seeds_model_from_siblings():
    pool = PilotPool([PilotDescription(n_slots=1, name="a"),
                      PilotDescription(n_slots=1, name="b")],
                     steal=False, preempt=False)
    try:
        a, b = pool.pilots
        a.store.seed_durations("k", 2.0, 0.0, 4)
        b.store.seed_durations("k", 4.0, 0.0, 4)
        fresh = pool.add_pilot(PilotDescription(n_slots=1, name="c"))
        mean, _var, n = fresh.store.duration_stats("k")
        assert n == 8
        assert mean == pytest.approx(3.0)       # n-weighted across both
        cold = pool.add_pilot(PilotDescription(n_slots=1, name="d"),
                              seed_durations=False)
        assert cold.store.duration_stats("k") is None
    finally:
        pool.close()


def test_model_kind_prefers_app_kind():
    t = TaskRecord(uid="x", kind="python", app_kind="bash")
    assert model_kind(t) == "bash"
    t2 = TaskRecord(uid="y", kind="python")
    assert model_kind(t2) == "python"
