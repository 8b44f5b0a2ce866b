"""Property tests for the device-slot scheduler (RP Agent analog)."""
import pytest

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:                      # fall back to the vendored shim
    from _propshim import given, settings, st

from repro_torch.core.scheduler import SlotScheduler, _align_of


def test_align_of():
    assert [_align_of(n) for n in (1, 2, 3, 4, 5, 8, 9)] == \
        [1, 2, 4, 4, 8, 8, 16]


def test_basic_alloc_release():
    s = SlotScheduler(16)
    a = s.allocate("t1", 4)
    assert a == (0, 1, 2, 3)
    b = s.allocate("t2", 4)
    assert b == (4, 5, 6, 7)
    assert s.n_free == 8
    s.release("t1")
    c = s.allocate("t3", 8)
    assert c == (8, 9, 10, 11, 12, 13, 14, 15)
    d = s.allocate("t4", 4)
    assert d == (0, 1, 2, 3)          # reused released block
    assert s.allocate("t5", 4) is None


def test_alignment_prevents_straddle():
    s = SlotScheduler(16)
    s.allocate("a", 2)                 # 0-1
    got = s.allocate("b", 8)           # must start at 8, not 2
    assert got == tuple(range(8, 16))


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["alloc", "release", "fail",
                                           "grow", "shrink"]),
                          st.integers(1, 16)), min_size=1, max_size=60))
def test_invariants_under_churn(ops):
    s = SlotScheduler(32)
    live = {}
    i = 0
    for op, n in ops:
        i += 1
        if op == "alloc":
            uid = f"t{i}"
            got = s.allocate(uid, n)
            if got is not None:
                assert len(got) == n
                # contiguity + alignment
                assert list(got) == list(range(got[0], got[0] + n))
                assert got[0] % _align_of(n) == 0
                # no overlap with any live allocation
                for other in live.values():
                    assert not (set(got) & set(other))
                live[uid] = got
        elif op == "release" and live:
            uid = sorted(live)[n % len(live)]
            s.release(uid)
            del live[uid]
        elif op == "fail":
            victims = s.mark_failed([n % 32])
            for v in victims:
                s.release(v)           # agent would fail+release the task
                live.pop(v, None)
        elif op == "grow":
            s.grow(n)
        elif op == "shrink":
            s.shrink(n)
    # capacity accounting: free + busy == capacity
    assert s.n_free + s.n_busy == s.capacity


def _check_invariants(s: SlotScheduler, live: dict):
    """Full invariant battery, checked after *every* op, not just at the
    end of a sequence."""
    # free + busy == capacity
    assert s.n_free + s.n_busy == s.capacity
    # interval list is sorted, disjoint, and coalesced
    blocks = s.free_blocks()
    for b0, b1 in blocks:
        assert b0 < b1
    for (a0, a1), (b0, b1) in zip(blocks, blocks[1:]):
        assert a1 < b0, f"blocks {blocks} not sorted/disjoint/coalesced"
    # no live allocation overlaps another, a free block, or a failed slot
    free = {x for b0, b1 in blocks for x in range(b0, b1)}
    seen = set()
    for uid, slots in live.items():
        got = set(slots)
        assert not (got & seen), "overlapping allocations"
        assert not (got & free), "allocated slot also marked free"
        assert not (got & s._failed), "allocated slot marked failed"
        seen |= got
        # contiguity + power-of-2 aligned start
        lo = min(slots)
        assert sorted(slots) == list(range(lo, lo + len(slots)))
        assert lo % _align_of(len(slots)) == 0


def _churn(ops, n_slots=32):
    """Drive a random op sequence, verifying invariants at every step."""
    s = SlotScheduler(n_slots)
    live = {}
    i = 0
    for op, n in ops:
        i += 1
        if op == "alloc":
            uid = f"t{i}"
            got = s.allocate(uid, n)
            if got is not None:
                assert len(got) == n
                live[uid] = got
        elif op == "release" and live:
            uid = sorted(live)[n % len(live)]
            s.release(uid)
            del live[uid]
        elif op == "fail":
            victims = s.mark_failed([n % (n_slots * 2)])
            for v in victims:
                s.release(v)           # agent would fail+release the task
                live.pop(v, None)
        elif op == "grow":
            s.grow(n)
        elif op == "shrink":
            s.shrink(n)
        _check_invariants(s, live)


@settings(max_examples=150, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["alloc", "release", "fail",
                                           "grow", "shrink"]),
                          st.integers(1, 16)), min_size=1, max_size=40))
def test_stepwise_invariants_under_churn(ops):
    """free+busy == capacity, no overlapping allocations, aligned starts,
    and a sorted/disjoint/coalesced free-interval list — after every
    single allocate/release/grow/shrink/mark_failed, not just at the end."""
    _churn(ops)


@pytest.mark.slow
@settings(max_examples=500, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["alloc", "release", "fail",
                                           "grow", "shrink"]),
                          st.integers(1, 32)), min_size=1, max_size=120))
def test_stepwise_invariants_under_churn_deep(ops):
    """The heavy version of the churn property (longer sequences, larger
    requests, more examples) — runs in CI's dedicated property-test job."""
    _churn(ops)


@settings(max_examples=50, deadline=None)
@given(st.lists(st.integers(1, 8), min_size=1, max_size=20))
def test_liveness_all_tasks_eventually_run(sizes):
    """Any finite task list completes: allocate/release in waves."""
    s = SlotScheduler(8)
    pending = [(f"t{i}", n) for i, n in enumerate(sizes)]
    done = []
    for _ in range(1000):
        if not pending:
            break
        still = []
        for uid, n in pending:
            got = s.allocate(uid, n)
            if got is None:
                still.append((uid, n))
            else:
                done.append(uid)
                s.release(uid)
        pending = still
    assert not pending


def test_largest_free_block_always_allocatable():
    """The documented no-lost-capacity invariant: any request up to the
    largest aligned free block must succeed."""
    s = SlotScheduler(16)
    s.allocate("a", 2)
    s.allocate("b", 4)
    s.release("a")
    n = s.largest_free_block()
    assert n == 8                      # [8, 16) is free and aligned
    assert s.allocate("c", n) is not None
    assert s.largest_free_block() == 4  # [0, 4): b was aligned to slot 4
    assert s.allocate("d", 4) == (0, 1, 2, 3)


def test_mark_failed_out_of_extent_is_noop():
    """Found by test_stepwise_invariants_under_churn_deep: failing a slot
    id that was never part of the extent used to decrement capacity (and
    poison the failed set with ids a later grow() would hand out)."""
    s = SlotScheduler(8)
    assert s.mark_failed([40]) == []
    assert s.capacity == 8 and s.n_free == 8
    assert s.mark_failed([-1]) == []
    assert s.capacity == 8
    s.grow(40)                          # extent now covers slot 40
    assert s.n_free + s.n_busy == s.capacity == 48
    got = s.allocate("t", 48)
    assert got is not None and 40 in got


def test_failed_slots_never_reallocated():
    s = SlotScheduler(8)
    s.mark_failed([0, 1, 2, 3])
    got = s.allocate("t", 4)
    assert got == (4, 5, 6, 7)
    assert s.allocate("t2", 2) is None  # only failed slots remain
    s.release("t")
    assert s.allocate("t3", 4) == (4, 5, 6, 7)
