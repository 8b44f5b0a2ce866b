"""RPEX — the RADICAL-Pilot Executor for the DFK (the paper's §IV-D).

A Parsl-style executor that bootstraps the pilot runtime on initialization
(PilotManager + TaskManager, as the paper describes), translates each Parsl
task through the Task Translator, and reflects pilot task states back into
AppFutures.  Supports both the paper's stream submission (one by one, as
Parsl's DFK emits tasks) and the bulk mode the paper names as future work.

One RPEXExecutor may own *several* pilots (a PilotPool) with heterogeneous
descriptions — e.g. a CPU pilot for pure-Python pre/post-processing and a
device pilot for SPMD tasks.  The translator stamps each task's resource
kind and the TaskManager late-binds it to a compatible pilot chosen by a
pluggable ``PlacementPolicy`` (least-loaded by default), so one executor
serves heterogeneous tasks on heterogeneous resources (the paper's
central claim).

Descriptions may also mix *worker transports* (see docs/processes.md):
``PilotDescription(transport="proc")`` gives that pilot a pool of worker
OS processes executing python/bash bodies off the GIL (the RP
master/worker split), while ``"inproc"`` (default) keeps the original
thread pool — e.g. a proc CPU pilot for compute-heavy python tasks next
to an inproc device pilot for SPMD tasks, in one pool.

Placement is configured with the ``placement=`` kwarg: a policy name
(``"least-loaded"`` — the default — ``"locality"``, or ``"cost"``) or any
``repro_torch.core.placement.PlacementPolicy`` instance, e.g.
``RPEXExecutor(descs, placement=LocalityAware(locality_weight=0.75))`` or
``placement=CostModelPolicy(inner="locality")``.  The policy decides
routing, bulk spreading, steal-victim ordering, per-task steal
eligibility, preemption-victim choice, and which scaler template spawns —
see docs/placement.md.  ``"cost"`` re-prices all of those in predicted
seconds from the per-(app_kind, pilot) duration model each pilot's
StateStore maintains (docs/scheduling.md); the same model drives the
agents' per-kind straggler deadlines and — with a ``ScalerConfig`` — the
PoolScaler's predictive scale-up signal, whichever placement policy is
active.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple, Union

from .executors import Executor, ParslTask
from .futures import AppFuture, TaskState
from .pilot import (Pilot, PilotDescription, PilotManager, PilotPool,
                    PoolScaler, ScalerConfig, TaskManager)
from .placement import PlacementPolicy, resolve_policy
from .store import union_intervals
from .translator import bind_future, translate

Descs = Union[PilotDescription, Sequence[PilotDescription]]


class RPEXExecutor(Executor):
    label = "rpex"
    supports_bulk = True
    resolves_refs = True     # edges may ship ObjectRefs: the executing
                             # pilot materializes them (docs/dataplane.md)

    def __init__(self, pilot_desc: Optional[Descs] = None,
                 pilot: Optional[Pilot] = None,
                 pilots: Optional[Sequence[Pilot]] = None,
                 scaler: Optional[ScalerConfig] = None,
                 steal: bool = True,
                 preempt: bool = True,
                 placement: Union[None, str, PlacementPolicy] = None,
                 heartbeat_timeout_s: Optional[float] = None,
                 data_plane: bool = True,
                 data_threshold: Optional[int] = None):
        # "Once initialized, RPEX ... starts a new RP session and creates
        # the Pilot Manager and the Task Manager."
        policy = resolve_policy(placement)
        self._own_pilots = pilot is None and pilots is None
        if self._own_pilots:
            if pilot_desc is None:
                descs = [PilotDescription()]
            elif isinstance(pilot_desc, PilotDescription):
                descs = [pilot_desc]
            else:
                descs = list(pilot_desc)
            self.pmgr = PilotManager()
            self.pool = self.pmgr.submit_pilots(
                descs, steal=steal, preempt=preempt, policy=policy,
                heartbeat_timeout_s=heartbeat_timeout_s,
                data_plane=data_plane, data_threshold=data_threshold)
        else:
            self.pmgr = None
            self.pool = PilotPool(
                pilots=list(pilots) if pilots is not None else [pilot],
                steal=steal, preempt=preempt, policy=policy,
                heartbeat_timeout_s=heartbeat_timeout_s,
                data_plane=data_plane, data_threshold=data_threshold)
        self.tmgr = TaskManager(self.pool)
        self.scaler = (PoolScaler(self.pool, scaler).start()
                       if scaler is not None else None)
        self.overhead_events: List[Tuple[str, float]] = []

    @property
    def pilot(self) -> Pilot:
        """Primary pilot (single-pilot compatibility accessor)."""
        return self.pool.pilots[0]

    @property
    def placement(self) -> PlacementPolicy:
        """The active placement policy (docs-visible; see
        docs/placement.md)."""
        return self.pool.policy

    @property
    def objectstore(self):
        """The pool's data plane (None with ``data_plane=False``) — its
        ``stats()`` expose bytes_moved/spills (docs/dataplane.md)."""
        return self.pool.objectstore

    # ------------------------------------------------------------------ #
    def submit(self, ptask: ParslTask, future: AppFuture):
        task = translate(ptask.fn, ptask.args, ptask.kwargs,
                         ptask.resources, ptask.retries,
                         affinity=ptask.affinity,
                         retry_policy=ptask.retry_policy,
                         affinity_bytes=ptask.affinity_bytes)
        future.task = task
        self.tmgr.submit(task, done_cb=bind_future(task, future),
                         workflow_key=ptask.key)

    def submit_bulk(self, pairs: List[Tuple[ParslTask, AppFuture]]):
        tasks = []
        keys = {}
        cbs = {}
        for pt, fut in pairs:
            task = translate(pt.fn, pt.args, pt.kwargs, pt.resources,
                             pt.retries, affinity=pt.affinity,
                             retry_policy=pt.retry_policy,
                             affinity_bytes=pt.affinity_bytes)
            fut.task = task
            if pt.key is not None:
                keys[task.uid] = pt.key
            cbs[task.uid] = bind_future(task, fut)
            tasks.append(task)

        def cb(t):
            uid = t.uid if t.replica_of is None else t.replica_of
            f = cbs.pop(uid, None)
            if f is not None:
                f(t)

        self.tmgr.submit_bulk(tasks, done_cb=cb, workflow_keys=keys)

    # ------------------------------------------------------------------ #
    def completed_result(self, workflow_key: str):
        """(found, result) across every pilot's journal — including
        retired pilots, since a stolen task's DONE record lives in the
        journal of the pilot that actually ran it."""
        for p in self.pool.all_pilots():
            found, result = p.store.completed_result(workflow_key)
            if found:
                return True, result
        return False, None

    def checkpoint_step(self, workflow_key: str):
        """Latest checkpointed step recorded for this key across every
        pilot (incl. retired), or None — the partial-restart analog of
        ``completed_result``: a key that is not DONE but has a
        checkpoint will re-execute and resume from this step."""
        return self.pool.checkpoint_step(workflow_key)

    def utilization(self):
        """Per-pilot busy-slot fraction across the (possibly elastic)
        pilot set (unified event stream backs the offline Fig.6-style
        breakdown; see StateStore.utilization)."""
        return self.pool.utilization()

    def rp_overhead(self) -> float:
        """RP overhead in seconds: the wall-clock union of
        SCHEDULED->RUNNING intervals across every pilot, including retired
        ones.  Unlike the per-task timestamp sum, this neither
        double-counts concurrent launches nor charges slot-idle gaps
        between dependent tasks.  Each store maintains its closed
        intervals incrementally, so the cross-pilot merge unions O(tasks)
        intervals instead of re-scanning O(events) stream records.
        History whose intervals were compacted away survives as each
        store's scalar base — summed, since cross-pilot overlap of that
        prefix is no longer reconstructable (a documented upper bound)."""
        ivals = []
        base = 0.0
        for p in self.pool.all_pilots():
            ivals.extend(p.store.overhead_intervals())
            base += p.store.overhead_base()
        return base + union_intervals(ivals)

    def drain(self, timeout: Optional[float] = None) -> bool:
        return self.tmgr.wait(timeout=timeout)

    def shutdown(self):
        if self.scaler is not None:
            self.scaler.stop()
        if self._own_pilots:
            self.pool.close()
            if self.pmgr is not None:
                self.pmgr.pilots.clear()
