"""Device-slot scheduler — the RP Agent scheduler analog.

Slots are devices in the pilot's device grid, identified 0..N-1 in mesh
order.  Allocation is *contiguous + power-of-2 aligned* first-fit: a
contiguous aligned range of the flattened mesh corresponds to a compact
block of cards (on one host, cards that share NVLink; the analogue of
giving each MPI Intra-communicator a compact node set), and alignment
prevents the fragmentation that would otherwise strand capacity under
churn.

The free set is kept as a sorted list of disjoint, coalesced [start, end)
intervals (a buddy-style free-block list) instead of a flat slot set, so an
allocation probe touches O(#blocks) aligned candidates rather than scanning
every slot of the extent — the difference between O(blocks) and O(extent)
per allocate under the churn the agent loop generates.

The scheduler is also the wakeup source for the event-driven agent loop:
``add_listener`` registers a callback fired (outside the scheduler lock)
whenever capacity may have increased — release or grow — so a blocked
scheduling pass waits on its condition variable instead of polling.

Invariants (property-tested in tests/test_scheduler.py):
  * an allocated slot is never allocated to a second task until released
  * allocations never include failed or shrunk-away slots
  * allocate(n) returns exactly n contiguous slots aligned to 2^ceil(log2 n)
    (for power-of-2 n) or None
  * release() makes slots reusable; fragmentation never loses capacity
    (any request <= largest aligned free block succeeds)
"""
from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, List, Optional, Tuple


def _align_of(n: int) -> int:
    a = 1
    while a < n:
        a *= 2
    return a


class SlotScheduler:
    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self._lock = threading.Lock()
        self.capacity = n_slots          # includes busy, excludes failed
        self._extent = n_slots           # highest slot id ever + 1
        self._blocks: List[List[int]] = [[0, n_slots]]  # sorted [start, end)
        self._failed: set = set()
        self._busy: Dict[str, Tuple[int, ...]] = {}   # uid -> slots
        self._listeners: List[Callable[[], None]] = []

    # ---------------------------- listeners ---------------------------- #
    def add_listener(self, cb: Callable[[], None]):
        """Register a capacity-increase callback (release/grow).  Fired
        outside the scheduler lock so listeners may take their own locks."""
        with self._lock:
            self._listeners.append(cb)

    def _notify(self):
        for cb in list(self._listeners):
            cb()

    # --------------------------- free blocks --------------------------- #
    def _insert_free(self, start: int, end: int):
        """Insert [start, end) into the block list, coalescing neighbors.
        Caller holds the lock."""
        if start >= end:
            return
        i = bisect.bisect_left(self._blocks, [start, end])
        # merge with predecessor
        if i > 0 and self._blocks[i - 1][1] == start:
            i -= 1
            self._blocks[i][1] = end
        else:
            self._blocks.insert(i, [start, end])
        # merge with successor
        if i + 1 < len(self._blocks) and self._blocks[i][1] == \
                self._blocks[i + 1][0]:
            self._blocks[i][1] = self._blocks[i + 1][1]
            del self._blocks[i + 1]

    def _carve(self, i: int, start: int, end: int):
        """Remove [start, end) from block i.  Caller holds the lock."""
        b0, b1 = self._blocks[i]
        repl = []
        if b0 < start:
            repl.append([b0, start])
        if end < b1:
            repl.append([end, b1])
        self._blocks[i:i + 1] = repl

    def _remove_free_slot(self, s: int) -> bool:
        """Drop a single free slot; True if it was free.  Caller holds
        the lock."""
        i = bisect.bisect_right(self._blocks, [s, float("inf")]) - 1
        if i >= 0 and self._blocks[i][0] <= s < self._blocks[i][1]:
            self._carve(i, s, s + 1)
            return True
        return False

    # ------------------------------ alloc ------------------------------ #
    def allocate(self, uid: str, n: int) -> Optional[Tuple[int, ...]]:
        """Contiguous aligned first-fit over free blocks; slot ids or None."""
        if n < 1:
            raise ValueError("n >= 1")
        align = _align_of(n)
        with self._lock:
            if uid in self._busy:
                raise KeyError(f"{uid} already holds an allocation")
            for i, (b0, b1) in enumerate(self._blocks):
                start = -(-b0 // align) * align     # first aligned start
                if start + n <= b1:
                    slots = tuple(range(start, start + n))
                    self._carve(i, start, start + n)
                    self._busy[uid] = slots
                    return slots
            return None

    def largest_free_block(self) -> int:
        """Largest aligned request guaranteed to succeed right now."""
        with self._lock:
            best = 0
            for b0, b1 in self._blocks:
                a = 1
                while True:
                    start = -(-b0 // a) * a
                    if start + a > b1:
                        break
                    best = max(best, a)
                    a *= 2
            return best

    def release(self, uid: str):
        with self._lock:
            slots = self._busy.pop(uid, ())
            freed = False
            run_start = None
            prev = None
            for s in list(slots) + [None]:      # sentinel flushes last run
                ok = (s is not None and s not in self._failed
                      and s < self._extent)
                if ok and run_start is None:
                    run_start = s
                elif not ok and run_start is not None:
                    self._insert_free(run_start, prev + 1)
                    freed = True
                    run_start = None
                prev = s
        if freed:
            self._notify()

    def owner_of(self, slot: int) -> Optional[str]:
        with self._lock:
            for uid, slots in self._busy.items():
                if slot in slots:
                    return uid
            return None

    # ------------------------------ fault ------------------------------ #
    def mark_failed(self, slots) -> List[str]:
        """Remove slots from service; returns uids of tasks running on them
        (the agent must fail/retry those tasks)."""
        with self._lock:
            victims = []
            for s in slots:
                if s in self._failed or not (0 <= s < self._extent):
                    # already failed, or never part of the extent: counting
                    # a nonexistent slot would corrupt capacity, and
                    # poisoning _failed with ids beyond the extent would
                    # break a later grow() that reuses them
                    continue
                self._failed.add(s)
                if self._remove_free_slot(s):
                    self.capacity -= 1
                else:
                    for uid, held in self._busy.items():
                        if s in held and uid not in victims:
                            victims.append(uid)
                    self.capacity -= 1
            return victims

    # ----------------------------- elastic ----------------------------- #
    def grow(self, n: int) -> Tuple[int, ...]:
        with self._lock:
            new = tuple(range(self._extent, self._extent + n))
            self._insert_free(self._extent, self._extent + n)
            self._extent += n
            self.capacity += n
        self._notify()
        return new

    def shrink(self, n: int) -> Tuple[int, ...]:
        """Retire up to n FREE slots (never preempts running tasks),
        highest slot ids first."""
        with self._lock:
            victims = []
            for b in reversed(self._blocks):
                while len(victims) < n and b[1] > b[0]:
                    b[1] -= 1
                    victims.append(b[1])
                if len(victims) >= n:
                    break
            self._blocks = [b for b in self._blocks if b[1] > b[0]]
            for s in victims:
                self._failed.add(s)     # retired == out of service
                self.capacity -= 1
            return tuple(victims)

    # ------------------------------ stats ------------------------------ #
    def free_blocks(self) -> List[Tuple[int, int]]:
        """Snapshot of the free interval list — invariant: sorted,
        disjoint, coalesced (no two adjacent blocks touch)."""
        with self._lock:
            return [(b0, b1) for b0, b1 in self._blocks]

    @property
    def n_free(self) -> int:
        with self._lock:
            return sum(b1 - b0 for b0, b1 in self._blocks)

    @property
    def n_busy(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._busy.values())

    def utilization(self) -> float:
        with self._lock:
            busy = sum(len(v) for v in self._busy.values())
            total = sum(b1 - b0 for b0, b1 in self._blocks) + busy
            return busy / total if total else 0.0
