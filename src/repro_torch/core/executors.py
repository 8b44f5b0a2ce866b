"""Executor interface (concurrent.futures-style, as Parsl uses) + the
ThreadPool baseline executor (the HTEX stand-in used for comparison runs).
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor as _TPE
from typing import Callable, List, Optional, Tuple

from ..device import resolve_device
from .futures import AppFuture, ResourceSpec, TaskRecord
from .spmd_executor import single_device_mesh
from .translator import bind_future, translate


class ParslTask:
    """What the DFK hands an executor: the app + resolved args, plus the
    executor-kind hint the DFK resolved for it (threaded through so bulk
    batches and pilot routing can see where the task was bound) and the
    data-affinity hint (the pilots that produced this task's inputs,
    recorded by the dep manager for locality-aware placement)."""

    __slots__ = ("fn", "args", "kwargs", "resources", "retries", "key",
                 "executor", "affinity", "affinity_bytes", "retry_policy")

    def __init__(self, fn, args, kwargs, resources=None, retries=0,
                 key: Optional[str] = None, executor: Optional[str] = None,
                 affinity: Tuple[str, ...] = (), retry_policy=None,
                 affinity_bytes=None):
        self.fn, self.args, self.kwargs = fn, args, kwargs
        self.resources = resources
        self.retries = retries
        self.key = key
        self.executor = executor
        self.affinity = affinity
        self.affinity_bytes = affinity_bytes   # {producer pilot: bytes}
        self.retry_policy = retry_policy


class Executor:
    label = "base"
    supports_bulk = False

    def submit(self, ptask: ParslTask, future: AppFuture):
        raise NotImplementedError

    def submit_bulk(self, pairs: List[Tuple[ParslTask, AppFuture]]):
        for pt, fut in pairs:
            self.submit(pt, fut)

    def shutdown(self):
        pass


class ThreadPoolExecutor(Executor):
    """Single-node thread pool (no slot management, no SPMD placement) —
    the baseline Parsl-HTEX-like executor Exp-2 compares RPEX against."""

    label = "threads"

    def __init__(self, max_workers: int = 8, device=None):
        self._pool = _TPE(max_workers=max_workers)
        # spmd bodies get the one-device sub-mesh on this device (None:
        # cuda, which raises at the task without a card)
        self.device = device

    def submit(self, ptask: ParslTask, future: AppFuture):
        task = translate(ptask.fn, ptask.args, ptask.kwargs,
                         ptask.resources, ptask.retries)
        future.task = task

        def run():
            from .futures import TaskState
            task.transition(TaskState.RUNNING)
            try:
                if task.kind == "spmd":
                    mesh = single_device_mesh(resolve_device(self.device))
                    res = task.fn(mesh, *task.args, **task.kwargs)
                else:
                    res = task.fn(*task.args, **task.kwargs)
                task.result = res
                task.transition(TaskState.DONE)
                future.set_result(res)
            except BaseException as e:  # noqa: BLE001
                task.error = e
                task.transition(TaskState.FAILED)
                future.set_exception(e)

        self._pool.submit(run)

    def shutdown(self):
        self._pool.shutdown(wait=False)
