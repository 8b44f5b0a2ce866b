"""Pluggable placement layer: LeastLoaded parity with the PR-2 hardcoded
routing, LocalityAware affinity scoring and steal gating, composable
tie-breaking, kind-aware template selection, and the affinity stamp's
path through ResourceSpec / translator / DFK dep manager."""
import threading
import time

import pytest
import torch

from repro_torch.core import (DataFlowKernel, LeastLoaded, LocalityAware,
                              PilotPool, PlacementPolicy,
                              RPEXExecutor, ResourceSpec, TaskState,
                              affinity_match, prefer_specialized, python_app,
                              resolve_policy, translate)
from repro_torch.core import PilotDescription as _PilotDescription


def PilotDescription(*args, **kw):
    """The suite's pilot descriptions on the CPU, asked for explicitly: a
    description without devices means every CUDA device, and raises
    without a card."""
    kw.setdefault("devices", [torch.device("cpu")])
    return _PilotDescription(*args, **kw)


def _pool(*descs, **kw):
    return PilotPool([PilotDescription(**d) for d in descs], **kw)


def _occupy(pilot, n, gate):
    """Pin n gated blockers straight onto one pilot to shape load."""
    tasks = [translate(lambda: gate.wait(15), (), {}) for _ in range(n)]
    for t in tasks:
        pilot.agent.submit(t)
    return tasks


# ------------------------- LeastLoaded parity ---------------------------- #

def test_least_loaded_route_matches_pr2_min_by_load():
    """Default-policy route() == min(compatible, key=load), first of
    equals — the exact PR-2 expression."""
    pool = _pool(dict(n_slots=2, name="a"), dict(n_slots=2, name="b"),
                 dict(n_slots=2, name="c"))
    try:
        gate = threading.Event()
        a, b, c = pool.pilots
        _occupy(a, 3, gate)
        _occupy(b, 1, gate)
        time.sleep(0.05)
        for _ in range(4):
            t = translate(lambda: 1, (), {})
            want = min([p for p in pool.pilots if p.accepts(t)],
                       key=lambda p: p.load())
            assert pool.route(t) is want
        gate.set()
    finally:
        gate.set()
        pool.close()


def test_least_loaded_route_bulk_matches_pr2_greedy():
    """Bulk placement under the default policy reproduces the PR-2
    greedy: running load estimate includes demand placed earlier in the
    batch, unroutable tasks yield their exception in place."""
    pool = _pool(dict(n_slots=2, name="a", kinds=("python", "bash")),
                 dict(n_slots=4, name="b"))
    try:
        tasks = [translate(lambda: 1, (), {},
                           ResourceSpec(slots=1 + (i % 2)))
                 for i in range(8)]

        def spmd_fn(mesh):
            return 0
        spmd_fn.__app_kind__ = "spmd"
        bad = translate(spmd_fn, (), {})
        bad.res_kind = "weird"
        bad.kind = bad.app_kind = "weird"
        tasks.insert(3, bad)

        # the PR-2 reference implementation, verbatim
        pilots = pool.active()
        loads = {p.uid: p.load() for p in pilots}
        caps = {p.uid: max(1, p.scheduler.capacity) for p in pilots}
        want = []
        for t in tasks:
            compat = [p for p in pilots if p.accepts(t)]
            if not compat:
                want.append(None)                     # exception slot
                continue
            p = min(compat, key=lambda p: loads[p.uid])
            loads[p.uid] += t.resources.slots / caps[p.uid]
            want.append(p)

        got = pool.route_bulk(tasks)
        for g, w in zip(got, want):
            if w is None:
                assert isinstance(g, RuntimeError)
            else:
                assert g is w
    finally:
        pool.close()


def test_resolve_policy_names_and_errors():
    assert isinstance(resolve_policy(None), LeastLoaded)
    assert isinstance(resolve_policy("least-loaded"), LeastLoaded)
    assert isinstance(resolve_policy("LOCALITY"), LocalityAware)
    p = LocalityAware(locality_weight=2.0)
    assert resolve_policy(p) is p
    with pytest.raises(ValueError, match="unknown placement policy"):
        resolve_policy("who-knows")
    with pytest.raises(ValueError, match="locality_weight"):
        LocalityAware(locality_weight=-1)


# ------------------------- LocalityAware scoring ------------------------- #

def test_locality_scoring_follows_affinity_within_weight():
    """An affine pilot wins while the load gap stays under the locality
    weight; past the weight, load takes over (locality is soft)."""
    pool = _pool(dict(n_slots=2, name="a"), dict(n_slots=2, name="b"),
                 policy=LocalityAware(locality_weight=0.5))
    try:
        gate = threading.Event()
        a, b = pool.pilots
        t = translate(lambda: 1, (), {})
        t.affinity = (b.uid,)
        assert pool.route(t) is b           # equal load: affinity wins

        _occupy(b, 1, gate)                 # load gap 0.5 == weight: the
        time.sleep(0.05)                    # affinity bonus no longer wins
        t2 = translate(lambda: 1, (), {})
        t2.affinity = (b.uid,)
        assert pool.route(t2) is a

        # by-name hints work too (device hints name pilots, not uids)
        t3 = translate(lambda: 1, (), {},
                       ResourceSpec(affinity=("a",)))
        assert t3.affinity == ("a",)
        assert pool.route(t3) is a
        gate.set()
    finally:
        gate.set()
        pool.close()


def test_affinity_match_fractions():
    pool = _pool(dict(n_slots=1, name="a"), dict(n_slots=1, name="b"))
    try:
        a, b = pool.pilots
        t = translate(lambda: 1, (), {})
        assert affinity_match(t, a) == 0.0            # no hints
        t.affinity = (a.uid, b.uid)
        assert affinity_match(t, a) == 0.5
        t.affinity = (a.uid, "a")
        assert affinity_match(t, a) == 1.0
        assert affinity_match(t, b) == 0.0
    finally:
        pool.close()


def test_locality_weight_zero_degenerates_to_least_loaded():
    pool = _pool(dict(n_slots=2, name="a"), dict(n_slots=2, name="b"),
                 policy=LocalityAware(locality_weight=0.0))
    try:
        t = translate(lambda: 1, (), {})
        t.affinity = (pool.pilots[1].uid,)
        # zero weight: affinity ignored, first-of-equals like LeastLoaded
        assert pool.route(t) is pool.pilots[0]
    finally:
        pool.close()


# ------------------------------ tie-breaks ------------------------------- #

def test_tie_breaks_compose_after_primary_score():
    """prefer_specialized steers equal-load ties onto kind-restricted
    pilots so generalists stay free; without it, enumeration order
    rules."""
    descs = [dict(n_slots=2, name="generalist"),
             dict(n_slots=2, name="pyonly", kinds=("python", "bash"))]
    plain = _pool(*descs)
    tied = _pool(*descs,
                 policy=LeastLoaded(tie_breaks=(prefer_specialized,)))
    try:
        t = translate(lambda: 1, (), {})
        assert plain.route(t).desc.name == "generalist"   # listing order
        assert tied.route(t).desc.name == "pyonly"        # tie-break
    finally:
        plain.close()
        tied.close()


# --------------------------- steal eligibility --------------------------- #

def test_locality_steal_gate_weighs_affinity_against_imbalance():
    policy = LocalityAware(locality_weight=0.5)
    pool = _pool(dict(n_slots=2, name="v"), dict(n_slots=2, name="th"))
    try:
        victim, thief = pool.pilots
        free = translate(lambda: 1, (), {})
        assert policy.steal_eligible(free, thief, victim, imbalance=0.01)

        affine = translate(lambda: 1, (), {})
        affine.affinity = (victim.uid,)
        # penalty = 0.5: a small backlog does not justify the move...
        assert not policy.steal_eligible(affine, thief, victim,
                                         imbalance=0.25)
        # ...a starving backlog does
        assert policy.steal_eligible(affine, thief, victim, imbalance=1.0)

        # affinity *toward the thief* makes stealing a win at any load
        toward = translate(lambda: 1, (), {})
        toward.affinity = (thief.uid,)
        assert policy.steal_eligible(toward, thief, victim, imbalance=0.0)
    finally:
        pool.close()


def test_affine_tasks_stay_put_when_backlog_is_small():
    """End-to-end: with LocalityAware, a hungry sibling does not strip a
    short affine backlog off the victim (LeastLoaded would)."""
    pool = _pool(dict(n_slots=1, name="v"), dict(n_slots=1, name="th"),
                 steal=False, policy=LocalityAware(locality_weight=2.0))
    try:
        victim, thief = pool.pilots
        gate = threading.Event()
        _occupy(victim, 1, gate)            # occupy the only slot
        time.sleep(0.05)
        affine = translate(lambda: "x", (), {})
        affine.affinity = (victim.uid,)
        victim.agent.submit(affine)         # queued: backlog of 1 slot

        # imbalance 1.0 < weight 2.0: the gate refuses the migration
        assert pool.request_work(thief) == 0
        assert victim.agent.queued_demand() == 1
        gate.set()
        assert victim.agent.wait_idle(timeout=10)
        assert affine.state == TaskState.DONE
        assert affine.pilot_uid != thief.uid
    finally:
        gate.set()
        pool.close()


# ------------------------- pick_template (scaling) ----------------------- #

def test_pick_template_matches_starving_kinds():
    policy = PlacementPolicy()
    cpu = PilotDescription(name="cpu-t", kinds=("python", "bash"))
    dev = PilotDescription(name="dev-t", kinds=("spmd",))
    anyk = PilotDescription(name="any-t")

    # single template: PR-2 clone regardless of the queue
    assert policy.pick_template([(("spmd",), 8)], [cpu]) is cpu
    # empty starving queue: first template
    assert policy.pick_template([], [cpu, dev]) is cpu
    # demand decides: 8 starving spmd slots beat 2 python slots
    starving = [(("python",), 1), (("python",), 1), (("spmd", "device"), 8)]
    assert policy.pick_template(starving, [cpu, dev]) is dev
    assert policy.pick_template([(("python",), 4)], [cpu, dev]) is cpu
    # a kinds=None generalist covers everything but loses specialization
    # ties: equal coverage prefers the restricted template
    assert policy.pick_template([(("spmd",), 4)], [anyk, dev]) is dev
    # ...yet wins when only it covers the demand
    assert policy.pick_template([(("weird",), 4)], [cpu, dev, anyk]) is anyk


# ----------------------- affinity stamp threading ------------------------ #

def test_translator_merges_static_and_runtime_affinity():
    res = ResourceSpec(affinity=("dev0", "dev1"))
    t = translate(lambda: 1, (), {}, res, affinity=("dev1", "pilotX"))
    assert t.affinity == ("dev0", "dev1", "pilotX")     # deduped, ordered
    t2 = translate(lambda: 1, (), {})
    assert t2.affinity == ()

    @python_app(affinity=("warm",))
    def hinted():
        return 1
    fn = hinted.__wrapped_app__
    assert fn.__resources__.affinity == ("warm",)
    # bash translation rebuilds the ResourceSpec; hints must survive
    def cmd():
        return "true"
    cmd.__is_bash__ = True
    tb = translate(cmd, (), {}, ResourceSpec(affinity=("warm",)))
    assert tb.affinity == ("warm",)


def test_dfk_stamps_producer_pilot_as_consumer_affinity():
    """The dep manager records where each input was produced; the
    consumer's translated task carries those pilots in its affinity."""
    rpex = RPEXExecutor([PilotDescription(n_slots=2, name="only")])
    try:
        @python_app
        def produce():
            return 2

        @python_app
        def consume(x, y):
            return x + y["nested"][0]

        with DataFlowKernel(executors={"rpex": rpex}):
            f1, f2 = produce(), produce()
            g = consume(f1, {"nested": [f2]})
            assert g.result(timeout=15) == 4
        producer_pilots = {f1.task.pilot_uid, f2.task.pilot_uid}
        assert producer_pilots == {rpex.pilot.uid}
        assert set(g.task.affinity) == producer_pilots
    finally:
        rpex.shutdown()


def test_locality_consumer_follows_producer_pilot():
    """Two idle pilots: a consumer chain under LocalityAware stays on its
    producer's pilot end-to-end instead of ping-ponging by load.  The
    weight is set far above any transient backlog so the steal gate can
    never justify a migration — chains must stay put deterministically."""
    rpex = RPEXExecutor([PilotDescription(n_slots=2, name="p0"),
                         PilotDescription(n_slots=2, name="p1")],
                        placement=LocalityAware(locality_weight=8.0))
    try:
        @python_app
        def step(x):
            time.sleep(0.01)
            return x + 1

        with DataFlowKernel(executors={"rpex": rpex}):
            chains = []
            for _ in range(4):
                futs = [step(0)]
                for _ in range(3):
                    futs.append(step(futs[-1]))
                chains.append(futs)
            for futs in chains:
                assert futs[-1].result(timeout=15) == 4
        for futs in chains:
            pilots = {f.task.pilot_uid for f in futs}
            assert len(pilots) == 1, \
                f"chain migrated across pilots: {pilots}"
    finally:
        rpex.shutdown()
