"""repro_torch.core — RPEX: Parsl/DFK + RADICAL-Pilot integration, on torch
devices (CUDA cards, or the CPU when a pilot names it).

Public API:
    DataFlowKernel, python_app, spmd_app, bash_app   (Parsl side)
    RPEXExecutor, PilotDescription                   (the integration)
    PilotManager, TaskManager, Agent, SlotScheduler  (RP side)
    PlacementPolicy, LeastLoaded, LocalityAware      (placement layer)
    ObjectStore, ObjectRef                           (data plane)
"""
from .agent import Agent
from .apps import bash_app, python_app, spmd_app
from .checkpoint import Checkpoint, CheckpointStore, TaskPreempted
from .dfk import DataFlowKernel, current_dfk
from .executors import Executor, ParslTask, ThreadPoolExecutor
from .faults import FaultInjector, PilotLost, SlotFailure
from .futures import (AppFuture, ResourceSpec, RetryPolicy, TaskRecord,
                      TaskState, model_kind, new_uid)
from .objectstore import (BlobLeaf, ObjectRef, ObjectStore, estimate_size,
                          materialize)
from .pilot import (Pilot, PilotDescription, PilotManager, PilotPool,
                    PoolScaler, ScalerConfig, TaskManager)
from .placement import (CostModelPolicy, LeastLoaded, LocalityAware,
                        PlacementPolicy, affinity_match, filter_healthy,
                        prefer_free_slots, prefer_specialized,
                        remote_bytes, resolve_policy)
from .rpex import RPEXExecutor
from .scheduler import SlotScheduler
from .spmd_executor import SPMDFunctionExecutor
from .serializer import (RemoteError, RemoteTraceback, SerializationError,
                         UnserializableResult)
from .store import EVENTS, StateStore, overhead_from_events, union_intervals
from .translator import bind_future, detect_kind, translate
from .transport import (InprocTransport, ProcessTransport, WorkerDied,
                        make_transport)

# Opt-in concurrency watchdog (REPRO_LOCK_WATCHDOG=1): instruments every
# lock the runtime allocates from here on and validates task-state
# transitions.  Installed after the submodule imports above so the
# STATE_MACHINE hook finds futures fully loaded; lock *construction*
# happens at runtime, so nothing is missed by installing last.
from ..analysis.watchdog import maybe_install_from_env as _wd_install
_wd_install()
del _wd_install

__all__ = [
    "Agent", "AppFuture", "BlobLeaf", "Checkpoint", "CheckpointStore",
    "CostModelPolicy",
    "DataFlowKernel", "EVENTS", "Executor", "FaultInjector",
    "InprocTransport",
    "LeastLoaded",
    "LocalityAware", "ObjectRef", "ObjectStore", "ParslTask", "Pilot",
    "PilotDescription",
    "PilotLost",
    "PilotManager", "PilotPool", "PlacementPolicy", "PoolScaler",
    "ProcessTransport", "RPEXExecutor", "RemoteError", "RemoteTraceback",
    "ResourceSpec", "RetryPolicy", "SPMDFunctionExecutor", "ScalerConfig",
    "SerializationError", "SlotFailure", "SlotScheduler", "StateStore",
    "TaskManager",
    "TaskPreempted", "TaskRecord", "TaskState",
    "ThreadPoolExecutor", "UnserializableResult", "WorkerDied",
    "affinity_match", "bash_app", "bind_future",
    "current_dfk", "detect_kind", "estimate_size", "filter_healthy",
    "make_transport", "materialize",
    "model_kind", "new_uid",
    "overhead_from_events",
    "prefer_free_slots", "prefer_specialized", "python_app",
    "remote_bytes",
    "resolve_policy", "spmd_app", "translate", "union_intervals",
]
