"""Placement — the pluggable policy layer for *where* tasks land.

The paper's §IV integration hinges on placement: the translator attaches
resource requirements and RP late-binds tasks to pilots.  Through PR 3
that policy was smeared across four layers — the translator stamped
``res_kind``/``sticky``, ``PilotPool.route``/``route_bulk`` hardcoded
least-loaded, ``request_work`` hardcoded most-loaded-victim stealing, and
the ``PoolScaler`` could only clone one template.  This module extracts
all four decisions behind one protocol so policy and mechanism separate
(the split arXiv:2509.20819 motivates for hybrid AI-HPC workloads):

  ``place(task, pilots)``       — pick the pilot for one task
  ``place_bulk(...)``           — greedy batch placement with running loads
  ``pick_victim(thief, ...)``   — order steal victims for a hungry pilot
  ``steal_eligible(task, ...)`` — per-task migration gate inside a steal
  ``pick_preempt(thief, ...)``  — choose the RUNNING checkpointable task
                                  to preempt-and-migrate when the
                                  queued-only steal pass found nothing
  ``pick_template(...)``        — choose the scale-up template for the
                                  kinds that are actually starving

Three built-in policies:

  * ``LeastLoaded`` — PR-2 behavior, byte-for-byte: min demanded-slots /
    capacity, first-of-equals, most-loaded victim, steal anything
    compatible, clone the (single) template.  The default.
  * ``LocalityAware`` — data-affinity placement: every task may carry an
    ``affinity`` tuple of pilot uids/names (stamped by the translator
    from the pilots that produced its inputs, plus any ``ResourceSpec``
    hints).  Placement scores ``load - locality_weight * match`` so a
    consumer follows its producers' data unless the load gap exceeds the
    locality weight; stealing only migrates an affine task when the
    victim's backlog (imbalance) beats the affinity penalty — the soft
    sibling of the hard ``sticky`` stamp, which still pins absolutely.
  * ``CostModelPolicy`` — schedules on *predicted seconds*, not counted
    slots: wraps either of the above and re-prices placement, stealing,
    preemption, and victim ordering with the StateStore's per-(app_kind,
    pilot) duration model.  See the class docstring and
    docs/scheduling.md.

Tie-breaking composes: any policy takes a sequence of ``tie_break``
callables ``(task, pilot) -> float`` (lower preferred) applied in order
after the primary score — e.g. ``prefer_specialized`` keeps kind-
restricted pilots busy so ``kinds=None`` generalists stay free, and
``prefer_free_slots`` spreads onto warm capacity.  With no tie-breakers
the enumeration order rules, matching the historical ``min()`` behavior.
"""
from __future__ import annotations

import time
from typing import (Callable, Dict, List, Optional, Sequence, Tuple, Union,
                    TYPE_CHECKING)

if TYPE_CHECKING:                       # import cycle: pilot.py imports us
    from .futures import TaskRecord
    from .pilot import Pilot, PilotDescription

TieBreak = Callable[["TaskRecord", "Pilot"], float]

# starving-queue demand: one entry per queued task — (the identifiers the
# task routes under, its slot demand).  See Agent.queued_task_kinds().
KindDemand = Sequence[Tuple[Tuple[str, ...], int]]


def filter_healthy(pilots: Sequence["Pilot"],
                   heartbeat_timeout_s: Optional[float] = None
                   ) -> List["Pilot"]:
    """Health-aware candidate filtering: drop pilots that are visibly
    dead or dying *before* any policy scores them — a crashed agent, or
    (when heartbeat supervision is active) one whose liveness beat has
    aged past the timeout but has not yet been declared LOST.  Routing
    to such a pilot only strands the task until the health monitor's
    recovery sweep re-routes it anyway.  Callers fall back to the
    unfiltered list when nothing healthy remains (the monitor will sort
    the rest out)."""
    now = time.monotonic()
    out = []
    for p in pilots:
        agent = p.agent
        if getattr(agent, "crashed", False):
            continue
        if (heartbeat_timeout_s is not None
                and now - agent.last_beat > heartbeat_timeout_s):
            continue
        out.append(p)
    return out


# ------------------------- composable tie-breakers ------------------------ #

def prefer_specialized(task, pilot) -> float:
    """Prefer pilots whose description restricts kinds (and the narrower
    the restriction the better) — keeps ``kinds=None`` generalists free
    for tasks nothing else accepts."""
    kinds = pilot.desc.kinds
    return float(len(kinds)) if kinds is not None else float("inf")


def prefer_free_slots(task, pilot) -> float:
    """Prefer the pilot with more immediately-free slots."""
    return -float(pilot.scheduler.n_free)


class PlacementPolicy:
    """The placement protocol *and* its default implementation: least
    loaded (demanded slots / capacity), first-of-equals — exactly the
    routing PR 2 hardcoded in ``PilotPool``.  Subclass and override
    ``score`` / ``steal_eligible`` / ``pick_victim`` / ``pick_template``
    to change policy without touching mechanism."""

    name = "least-loaded"

    def __init__(self, tie_breaks: Sequence[TieBreak] = ()):
        self.tie_breaks = tuple(tie_breaks)

    # ------------------------------ scoring --------------------------- #
    def score(self, task: "TaskRecord", pilot: "Pilot",
              load: float) -> float:
        """Primary placement score; lower wins.  ``load`` is the demand
        estimate (running batch estimate during ``place_bulk``)."""
        return load

    def _key(self, task, pilot, load) -> tuple:
        return (self.score(task, pilot, load),
                *(tb(task, pilot) for tb in self.tie_breaks))

    # ------------------------------ placing --------------------------- #
    def place(self, task: "TaskRecord", pilots: Sequence["Pilot"],
              loads: Optional[Dict[str, float]] = None) -> "Pilot":
        """Pick one pilot among the (compatible, non-empty) candidates.
        ``loads`` optionally overrides live loads with a running batch
        estimate; first-of-equals on full ties keeps routing stable."""
        best = None
        best_key = None
        for p in pilots:
            load = loads[p.uid] if loads is not None else p.load()
            key = self._key(task, p, load)
            if best is None or key < best_key:
                best, best_key = p, key
        return best

    def place_bulk(self, items: Sequence[Tuple["TaskRecord", object]],
                   loads: Dict[str, float], caps: Dict[str, int]
                   ) -> List[Union["Pilot", Exception]]:
        """Greedy batch placement: each item is (task, candidates) where
        candidates is a pilot list or the routing Exception to pass
        through; ``loads`` accumulates the demand placed earlier in this
        batch so a bulk submission spreads instead of piling onto
        whichever pilot was idle when the batch arrived."""
        out: List[Union["Pilot", Exception]] = []
        for task, cands in items:
            if isinstance(cands, Exception):
                out.append(cands)
                continue
            p = self.place(task, cands, loads=loads)
            loads[p.uid] += task.resources.slots / caps[p.uid]
            out.append(p)
        return out

    # ------------------------------ stealing -------------------------- #
    def pick_victim(self, thief: "Pilot", pilots: Sequence["Pilot"],
                    demand: Dict[str, int]) -> List["Pilot"]:
        """Order candidate victims for a hungry thief, most attractive
        first; default: most queued backlog first (PR-2 behavior)."""
        return sorted(pilots, key=lambda p: demand.get(p.uid, 0),
                      reverse=True)

    def steal_eligible(self, task: "TaskRecord", thief: "Pilot",
                       victim: "Pilot", imbalance: float) -> bool:
        """Per-task migration gate evaluated inside the victim's steal
        sweep (compatibility, capacity fit, and the hard ``sticky`` pin
        are checked by the mechanism).  ``imbalance`` is the victim's
        queued backlog in load units (queued slots / capacity).  Default:
        any compatible task moves."""
        return True

    # ----------------------------- preemption -------------------------- #
    def pick_preempt(self, thief: "Pilot",
                     candidates: Sequence[Tuple["TaskRecord", "Pilot"]],
                     loads: Dict[str, float]
                     ) -> Optional[Tuple["TaskRecord", "Pilot"]]:
        """Choose one RUNNING task to preempt-and-migrate onto ``thief``
        after a queued-only steal pass found nothing.  ``candidates`` are
        (task, victim) pairs pre-gated by the mechanism (checkpointable,
        non-sticky, non-replica, kind-compatible, capacity fit — the
        Agent enforces the hard pins); ``loads`` maps each victim pilot
        uid to its queued backlog per slot of capacity — the same
        imbalance currency ``steal_eligible`` receives.  Default: take
        from the most-loaded victim, longest-running task first (it has
        the most checkpointed progress to carry over).  Return None to
        decline preemption entirely."""
        best, best_key = None, None
        for t, victim in candidates:
            key = (-loads.get(victim.uid, 0.0),
                   t.timestamps.get("RUNNING", float("inf")))
            if best is None or key < best_key:
                best, best_key = (t, victim), key
        return best

    # ------------------------------ scaling --------------------------- #
    def pick_template(self, starving_kinds: KindDemand,
                      templates: Sequence["PilotDescription"]
                      ) -> "PilotDescription":
        """Choose which template the PoolScaler spawns: the one whose
        ``kinds`` cover the most starving slot-demand, preferring the
        most specialized on ties (then listing order).  With one template
        — or an empty starving queue — this is the PR-2 clone."""
        templates = list(templates)
        if len(templates) == 1 or not starving_kinds:
            return templates[0]

        def covered(desc) -> int:
            if desc.kinds is None:
                return sum(slots for _, slots in starving_kinds)
            return sum(slots for kinds, slots in starving_kinds
                       if any(k in desc.kinds for k in kinds))

        best, best_key = templates[0], None
        for i, d in enumerate(templates):
            nk = len(d.kinds) if d.kinds is not None else float("inf")
            key = (-covered(d), nk, i)
            if best_key is None or key < best_key:
                best, best_key = d, key
        return best

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


class LeastLoaded(PlacementPolicy):
    """PR-2 routing, named: an explicit alias so configuration reads
    ``placement=LeastLoaded()`` (or ``placement=\"least-loaded\"``)."""


def affinity_match(task: "TaskRecord", pilot: "Pilot") -> float:
    """Fraction of the task's affinity this pilot satisfies (by pilot uid
    or description name); 0.0 for tasks with no affinity.

    With a ``TaskRecord.affinity_bytes`` stamp (the DFK dep manager's
    {producer pilot: input bytes} map, docs/dataplane.md) the fraction is
    *byte-weighted*: resident input bytes / total input bytes, so a
    consumer follows its largest input rather than counting producers
    equally — one 64 MB array outweighs any number of kilobyte configs.
    Without the stamp, the legacy uid-counted fraction applies."""
    name = pilot.desc.name
    ab = getattr(task, "affinity_bytes", None)
    if ab:
        total = sum(ab.values())
        if total > 0:
            matched = sum(v for k, v in ab.items()
                          if k == pilot.uid or (name and k == name))
            return matched / total
    aff = getattr(task, "affinity", ()) or ()
    if not aff:
        return 0.0
    hits = sum(1 for a in aff if a == pilot.uid or (name and a == name))
    return hits / len(aff)


def remote_bytes(task: "TaskRecord", pilot: "Pilot") -> int:
    """Input bytes NOT resident on ``pilot`` — what a placement there
    would move across pilots (0 for tasks without a byte stamp)."""
    ab = getattr(task, "affinity_bytes", None) or {}
    name = pilot.desc.name
    return sum(v for k, v in ab.items()
               if k != pilot.uid and not (name and k == name))


class LocalityAware(PlacementPolicy):
    """Data-affinity placement: score ``load - locality_weight * match``.

    ``locality_weight`` is denominated in load units (demanded slots per
    slot of capacity): a fully-affine pilot wins until its load exceeds a
    non-affine alternative's by the weight — ``0.0`` degenerates to
    ``LeastLoaded``, a large weight pins consumers to their producers'
    pilots no matter the queue.  Stealing applies the same currency: an
    affine task migrates only when the victim's backlog-per-slot beats
    the affinity penalty the move would pay, so a hungry sibling still
    absorbs a genuinely starving queue but never shuffles data-local
    work for marginal balance."""

    name = "locality"

    def __init__(self, locality_weight: float = 0.5,
                 tie_breaks: Sequence[TieBreak] = ()):
        super().__init__(tie_breaks=tie_breaks)
        if locality_weight < 0:
            raise ValueError(
                f"locality_weight must be >= 0, got {locality_weight}")
        self.locality_weight = locality_weight

    def score(self, task, pilot, load):
        return load - self.locality_weight * affinity_match(task, pilot)

    def steal_eligible(self, task, thief, victim, imbalance):
        penalty = self.locality_weight * (affinity_match(task, victim)
                                          - affinity_match(task, thief))
        return penalty <= 0 or imbalance > penalty

    def pick_preempt(self, thief, candidates, loads):
        """Affinity gates preemption in the same currency as stealing: a
        RUNNING task affine to its victim pilot only migrates when the
        victim's queued backlog per slot beats the affinity penalty of
        the move."""
        eligible = [(t, v) for t, v in candidates
                    if self.steal_eligible(t, thief, v,
                                           loads.get(v.uid, 0.0))]
        return super().pick_preempt(thief, eligible, loads)


class CostModelPolicy(PlacementPolicy):
    """Cost-model scheduling: every decision is priced in *predicted
    seconds* from the StateStore duration model instead of counted slots
    (see docs/scheduling.md).

    Wraps an inner policy (``LeastLoaded`` by default, or
    ``LocalityAware`` to keep data-affinity) and re-expresses its
    decisions in time:

      * ``place``/``place_bulk`` rank pilots by predicted completion:
        backlog seconds (per-kind queued+running slots x that kind's EWMA
        mean run time / capacity) plus the task's own predicted run time
        on that pilot, minus the affinity bonus converted to seconds.
      * ``steal_eligible`` compares the predicted wait a migration saves
        (victim backlog-per-slot x the victim's mixture mean) against the
        affinity penalty in seconds.
      * ``pick_preempt`` ranks victims by predicted *remaining* work
        (kind mean - observed run time), so the task that is nearly done
        stops being the default preemption victim; the checkpoint trail
        breaks ties (fewer saved steps = less banked progress).
      * ``pick_victim`` orders steal victims by queued backlog seconds,
        not queued slot counts.
      * ``place`` additionally prices *data staging*: a candidate pilot
        not holding the task's inputs pays ``remote_bytes(task, pilot) /
        bandwidth_bytes_s`` seconds (the DFK's byte-weighted affinity
        stamps supply the byte map; see docs/dataplane.md).

    Predictions fall back per (pilot, kind): the pilot's own kind EWMA ->
    the candidate fleet's kind aggregate -> the pilot's all-kind mixture
    -> the fleet mixture -> ``default_duration_s``.  With a completely
    cold model every candidate prices at the constant default, and the
    ranking degenerates exactly to the inner policy's count-based order —
    cold starts schedule like PR-2, warm models schedule on time."""

    name = "cost"

    def __init__(self, inner: Union[None, str, PlacementPolicy] = None,
                 default_duration_s: float = 1.0,
                 bandwidth_bytes_s: Optional[float] = 1e9,
                 tie_breaks: Sequence[TieBreak] = ()):
        super().__init__(tie_breaks=tie_breaks)
        self.inner = resolve_policy(inner)
        if isinstance(self.inner, CostModelPolicy):
            raise ValueError("CostModelPolicy cannot wrap itself")
        if default_duration_s <= 0:
            raise ValueError("default_duration_s must be > 0, "
                             f"got {default_duration_s}")
        self.default_duration_s = default_duration_s
        # transfer pricing (docs/dataplane.md): placing a task away from
        # its inputs costs remote_bytes / bandwidth seconds on top of the
        # compute eta — the data plane's byte stamps make staging cost a
        # first-class term.  None disables the term.
        if bandwidth_bytes_s is not None and bandwidth_bytes_s <= 0:
            raise ValueError("bandwidth_bytes_s must be > 0 or None, "
                             f"got {bandwidth_bytes_s}")
        self.bandwidth_bytes_s = bandwidth_bytes_s

    # --------------------------- predictions --------------------------- #
    def _fleet_model(self, pilots) -> Tuple[Dict[str, float],
                                            Optional[float]]:
        """({kind: n-weighted mean across the candidate pilots}, fleet
        mixture mean or None) — the cross-pilot fallback for kinds an
        individual pilot has not run yet."""
        agg: Dict[str, List[float]] = {}
        for p in pilots:
            for kind, (mean, _var, n) in p.store.duration_model().items():
                m = agg.setdefault(kind, [0.0, 0])
                tot = m[1] + n
                m[0] = (m[0] * m[1] + mean * n) / tot
                m[1] = tot
        n_all = sum(m[1] for m in agg.values())
        overall = (sum(m[0] * m[1] for m in agg.values()) / n_all
                   if n_all else None)
        return {k: m[0] for k, m in agg.items()}, overall

    def _run_mean(self, pilot, kind: Optional[str], fleet) -> float:
        """Predicted run time (seconds) of one ``kind`` task on ``pilot``,
        falling back pilot-kind -> fleet-kind -> pilot mixture -> fleet
        mixture -> the constant default (cold start)."""
        if kind is not None:
            st = pilot.store.duration_stats(kind)
            if st is not None:
                return st[0]
            if kind in fleet[0]:
                return fleet[0][kind]
        st = pilot.store.duration_stats(None)
        if st is not None:
            return st[0]
        if fleet[1] is not None:
            return fleet[1]
        return self.default_duration_s

    def _backlog_seconds(self, pilot, fleet) -> float:
        """Predicted seconds of queue wait a new arrival sees: each
        outstanding kind's slots priced at its predicted duration, spread
        over the pilot's capacity."""
        cap = max(1, pilot.scheduler.capacity)
        return sum(slots * self._run_mean(pilot, k, fleet)
                   for k, slots in pilot.agent.demand_by_kind().items()
                   ) / cap

    def _mixture_mean(self, pilot, fleet) -> float:
        """Demand-weighted mean duration of the pilot's current backlog —
        the seconds one load unit (slot per slot of capacity) stands for
        when converting count-based currencies."""
        by_kind = pilot.agent.demand_by_kind()
        tot = sum(by_kind.values())
        if tot:
            return sum(s * self._run_mean(pilot, k, fleet)
                       for k, s in by_kind.items()) / tot
        return self._run_mean(pilot, None, fleet)

    # ------------------------------ placing ----------------------------- #
    def place(self, task, pilots, loads=None, extra_s=None):
        from .futures import model_kind
        pilots = list(pilots)
        fleet = self._fleet_model(pilots)
        kind = model_kind(task)
        locality = (self.inner.locality_weight
                    if isinstance(self.inner, LocalityAware) else 0.0)
        best, best_key = None, None
        for p in pilots:
            run = self._run_mean(p, kind, fleet)
            eta = self._backlog_seconds(p, fleet) + run
            if extra_s is not None:
                eta += extra_s.get(p.uid, 0.0)
            elif loads is not None:
                # a generic caller's batch estimate arrives in load
                # units; price the delta over live load at the pilot's
                # mixture rate
                delta = loads[p.uid] - p.load()
                if delta > 0:
                    eta += delta * self._mixture_mean(p, fleet)
            if locality:
                # affinity bonus in seconds: the inner weight is load
                # units, one unit of this task is worth its run time
                eta -= locality * run * affinity_match(task, p)
            if self.bandwidth_bytes_s is not None:
                # staging cost: non-resident input bytes at the modeled
                # inter-pilot bandwidth
                eta += remote_bytes(task, p) / self.bandwidth_bytes_s
            key = (eta, *(tb(task, p) for tb in self.tie_breaks))
            if best is None or key < best_key:
                best, best_key = p, key
        return best

    def place_bulk(self, items, loads, caps):
        from .futures import model_kind
        out: List[Union["Pilot", Exception]] = []
        extra_s: Dict[str, float] = {}      # seconds this batch already
        for task, cands in items:           # queued onto each pilot
            if isinstance(cands, Exception):
                out.append(cands)
                continue
            p = self.place(task, cands, extra_s=extra_s)
            loads[p.uid] += task.resources.slots / caps[p.uid]
            fleet = self._fleet_model([p])
            extra_s[p.uid] = (extra_s.get(p.uid, 0.0)
                              + task.resources.slots
                              * self._run_mean(p, model_kind(task), fleet)
                              / caps[p.uid])
            out.append(p)
        return out

    # ------------------------------ stealing ---------------------------- #
    def pick_victim(self, thief, pilots, demand):
        """Most predicted-seconds of queued backlog first — a victim with
        few but long queued tasks outranks one with many short ones."""
        pilots = list(pilots)
        fleet = self._fleet_model(pilots + [thief])
        return sorted(
            pilots,
            key=lambda p: demand.get(p.uid, 0) * self._mixture_mean(p,
                                                                    fleet),
            reverse=True)

    def steal_eligible(self, task, thief, victim, imbalance):
        """Predicted wait saved vs the affinity penalty, both in seconds.
        ``imbalance`` (victim queued slots per slot of capacity) x the
        victim's mixture mean is the wait the move saves; a LocalityAware
        inner's penalty is its weight x the task's predicted run time x
        the affinity lost by moving."""
        from .futures import model_kind
        fleet = self._fleet_model([thief, victim])
        if not isinstance(self.inner, LocalityAware):
            return self.inner.steal_eligible(task, thief, victim,
                                             imbalance)
        penalty_s = (self.inner.locality_weight
                     * self._run_mean(victim, model_kind(task), fleet)
                     * (affinity_match(task, victim)
                        - affinity_match(task, thief)))
        saved_s = imbalance * self._mixture_mean(victim, fleet)
        return penalty_s <= 0 or saved_s > penalty_s

    # ----------------------------- preemption --------------------------- #
    def pick_preempt(self, thief, candidates, loads):
        """Rank victims by predicted *remaining* work, descending: the
        kind's EWMA mean minus the observed run time so far.  The default
        policy's longest-running-first rule preempts exactly the task
        that is about to finish — maximum migration overhead per second
        of remaining work; pricing the remainder inverts that.  Ties
        break on the checkpoint trail (fewer saved steps = less banked
        progress = preempt first), then the victim's queued backlog.  A
        LocalityAware inner's affinity gate applies first, in seconds."""
        import time as _time
        from .futures import model_kind
        if isinstance(self.inner, LocalityAware):
            candidates = [(t, v) for t, v in candidates
                          if self.steal_eligible(t, thief, v,
                                                 loads.get(v.uid, 0.0))]
        candidates = list(candidates)
        fleet = self._fleet_model([v for _, v in candidates] + [thief])
        now = _time.monotonic()
        best, best_key = None, None
        for t, v in candidates:
            elapsed = max(0.0, now - t.timestamps.get("RUNNING", now))
            remaining = self._run_mean(v, model_kind(t), fleet) - elapsed
            step = v.ckpt.step(t.ckpt_key or t.uid)
            key = (-remaining, step if step is not None else -1,
                   -loads.get(v.uid, 0.0))
            if best is None or key < best_key:
                best, best_key = (t, v), key
        return best

    # ------------------------------ scaling ----------------------------- #
    def pick_template(self, starving_kinds, templates):
        return self.inner.pick_template(starving_kinds, templates)


_POLICIES = {
    "least-loaded": LeastLoaded,
    "least_loaded": LeastLoaded,
    "leastloaded": LeastLoaded,
    "locality": LocalityAware,
    "locality-aware": LocalityAware,
    "locality_aware": LocalityAware,
    "cost": CostModelPolicy,
    "cost-model": CostModelPolicy,
    "cost_model": CostModelPolicy,
    "costmodel": CostModelPolicy,
}


def resolve_policy(policy: Union[None, str, PlacementPolicy]
                   ) -> PlacementPolicy:
    """None -> LeastLoaded(); a name -> its policy with defaults; an
    instance passes through (the RPEXExecutor/PilotPool kwarg surface)."""
    if policy is None:
        return LeastLoaded()
    if isinstance(policy, PlacementPolicy):
        return policy
    cls = _POLICIES.get(str(policy).lower())
    if cls is None:
        raise ValueError(
            f"unknown placement policy {policy!r}; "
            f"known: {sorted(set(_POLICIES))} or a PlacementPolicy instance")
    return cls()
