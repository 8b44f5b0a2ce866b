"""Task Translator — the paper's mid-point integration component.

Exactly the three capabilities of §IV-C:
  (i)  detect whether a Parsl task is a pure Python function, an SPMD
       (MPI-analog) function, or a Bash/executable call;
  (ii) translate the Parsl task 1:1 into a pilot TaskRecord, attaching the
       resource requirements (slots / sub-mesh) that Parsl's own API does
       not carry — supplied through the @spmd_app decorator's extension;
  (iii) reflect pilot task state back into the Parsl future via callbacks.
"""
from __future__ import annotations

import shlex
import subprocess
from typing import Callable, Optional, Sequence

from .futures import (AppFuture, ResourceSpec, RetryPolicy, TaskRecord,
                      TaskState, new_uid)


def detect_kind(fn: Callable) -> str:
    """Capability (i): classify the app callable."""
    kind = getattr(fn, "__app_kind__", None)
    if kind is not None:
        return kind
    if getattr(fn, "__is_bash__", False):
        return "bash"
    return "python"


def _bash_runner(cmd_builder: Callable):
    def run(*args, **kwargs):
        cmd = cmd_builder(*args, **kwargs)
        proc = subprocess.run(
            cmd if isinstance(cmd, list) else shlex.split(cmd),
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"bash app failed rc={proc.returncode}: {proc.stderr[:500]}")
        return proc.stdout
    return run


def translate(fn: Callable, args: tuple, kwargs: dict,
              resources: Optional[ResourceSpec] = None,
              max_retries: int = 0,
              affinity: Sequence[str] = (),
              retry_policy: Optional[RetryPolicy] = None,
              affinity_bytes: Optional[dict] = None) -> TaskRecord:
    """Capability (ii): 1:1 Parsl-task -> pilot-task translation.

    ``affinity`` carries runtime-discovered data-affinity hints (the DFK
    dep manager passes the pilots that produced this task's inputs); they
    merge — deduplicated, static ResourceSpec hints (input-array device /
    pilot names) first — into the
    ``TaskRecord.affinity`` stamp a LocalityAware placement policy scores.

    ``affinity_bytes`` ({producer pilot: input bytes}, also from the dep
    manager) upgrades that stamp to *byte-weighted* affinity: placement
    follows the largest input instead of counting producers equally
    (docs/dataplane.md).

    ``retry_policy`` supersedes the bare ``max_retries`` count when given:
    the attempt budget comes from ``retry_policy.max_retries`` and failed
    attempts get backoff, error classification, and poison quarantine
    (docs/resilience.md).
    """
    app_kind = kind = detect_kind(fn)   # classify once: translate() runs
    res = resources or getattr(fn, "__resources__", None) or ResourceSpec()
    body = fn                           # per task on the submit hot path
    if kind == "bash":
        body = _bash_runner(fn)
        kind = "python"  # executed as a single-slot callable wrapping a proc
        res = ResourceSpec(slots=res.slots, cpu_only=True,
                           priority=res.priority, sticky=res.sticky,
                           affinity=res.affinity,
                           checkpointable=res.checkpointable)
    kwargs = dict(kwargs)
    if kind == "spmd" and not getattr(fn, "__spmd_jit__", True):
        kwargs["_jit"] = False
    aff = tuple(res.affinity) + tuple(affinity)
    uid = new_uid("task")
    task = TaskRecord(
        uid=uid, kind=kind, fn=body, args=args, kwargs=kwargs,
        resources=res,
        max_retries=(retry_policy.max_retries if retry_policy is not None
                     else max_retries),
        retry_policy=retry_policy,
        app_kind=app_kind,
        sticky=res.sticky,
        affinity=tuple(dict.fromkeys(aff)) if aff else (),
        affinity_bytes=dict(affinity_bytes) if affinity_bytes else None,
        checkpointable=res.checkpointable,
        inproc_only=(kind == "spmd"),   # a sub-mesh binds to the agent
                                        # process's CUDA context: a proc
                                        # transport routes spmd inproc
        ckpt_key=uid,       # replicas inherit it; keyed workflows replace
                            # it with the stable workflow key (restart)
        res_kind=res.res_kind or (
            "device" if kind == "spmd" and not res.cpu_only else "cpu"))
    task.transition(TaskState.NEW)
    return task


def bind_future(task: TaskRecord, future: AppFuture):
    """Capability (iii): a done-callback that resolves the Parsl future from
    the pilot task's terminal state."""
    def cb(t: TaskRecord):
        if t.state == TaskState.DONE:
            future.set_result(t.result)
        else:
            future.set_exception(
                t.error or RuntimeError(f"{t.uid} ended {t.state.value}"))
    return cb
