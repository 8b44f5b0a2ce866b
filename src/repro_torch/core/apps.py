"""App decorators — the Parsl programming model, plus the resource-spec
extension the paper adds for RP (§IV-D: "we extended Parsl's API to allow
users to define those parameters").

  @python_app                      — single-slot Python function
  @spmd_app(slots=8, mesh=(4, 2))  — SPMD function over a device sub-mesh;
                                     body receives the sub-mesh first arg
  @bash_app                        — function returning a shell command line

Every decorator accepts ``retry_policy=RetryPolicy(...)`` as the richer
sibling of the bare ``retries=N`` count: exponential backoff with jitter,
infra-vs-app error classification (infra failures retry on a *different*
pilot), fatal-exception short-circuit, and poison-task quarantine
(docs/resilience.md).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

from .dfk import current_dfk
from .futures import AppFuture, ResourceSpec, RetryPolicy


def _mk_app(fn: Callable, kind: str, resources: ResourceSpec,
            retries: int, executor: Optional[str],
            retry_policy: Optional[RetryPolicy] = None):
    fn.__app_kind__ = kind
    fn.__resources__ = resources
    fn.__executor__ = executor

    @functools.wraps(fn)
    def invoke(*args, **kwargs) -> AppFuture:
        return current_dfk().submit(fn, args, kwargs, resources=resources,
                                    retries=retries, executor=executor,
                                    retry_policy=retry_policy)

    invoke.__wrapped_app__ = fn
    return invoke


def python_app(fn=None, *, retries: int = 0, executor: Optional[str] = None,
               slots: int = 1, sticky: bool = False,
               affinity: Sequence[str] = (), checkpointable: bool = False,
               retry_policy: Optional[RetryPolicy] = None):
    """sticky=True pins every invocation to the pilot it was routed to:
    the task is never migrated by inter-pilot work stealing (use for tasks
    with pilot-local state or data affinity).  ``affinity`` is the soft
    sibling: pilot uids/names this app's input data lives on; a
    LocalityAware placement policy scores routing toward them (merged
    with the producer pilots the dep manager discovers at run time).
    checkpointable=True hands the body a ``ckpt`` keyword (Checkpoint
    context: ``ckpt.restore()`` / ``ckpt.save(step, state)``) — partial
    progress survives straggler replication, cooperative preemption, and
    restarts (see docs/checkpointing.md).  ``retry_policy`` supersedes
    ``retries`` with backoff + classification (docs/resilience.md)."""
    def deco(f):
        return _mk_app(f, "python",
                       ResourceSpec(slots=slots, cpu_only=True,
                                    sticky=sticky,
                                    affinity=tuple(affinity),
                                    checkpointable=checkpointable),
                       retries, executor, retry_policy)
    return deco(fn) if fn is not None else deco


def spmd_app(fn=None, *, slots: int = 1,
             mesh: Optional[Tuple[int, int]] = None, retries: int = 0,
             executor: Optional[str] = None, priority: int = 0,
             jit: bool = True, sticky: bool = False,
             affinity: Sequence[str] = (), checkpointable: bool = False,
             retry_policy: Optional[RetryPolicy] = None):
    """jit=False for bodies that manage their own jit (e.g. a training
    segment calling a pre-jitted step) or that are not traceable.
    sticky=True exempts the task from inter-pilot work stealing;
    ``affinity`` names pilots holding this app's input arrays (soft
    data-locality hint for LocalityAware placement).  checkpointable=True
    hands the body a ``ckpt`` Checkpoint context (see python_app); the
    context is not traceable, so such bodies run un-jitted at the wrapper
    level and manage their own jit per step."""
    def deco(f):
        f.__spmd_jit__ = jit
        return _mk_app(f, "spmd",
                       ResourceSpec(slots=slots, mesh_shape=mesh,
                                    priority=priority, sticky=sticky,
                                    affinity=tuple(affinity),
                                    checkpointable=checkpointable),
                       retries, executor, retry_policy)
    return deco(fn) if fn is not None else deco


def bash_app(fn=None, *, retries: int = 0, executor: Optional[str] = None,
             retry_policy: Optional[RetryPolicy] = None):
    def deco(f):
        return _mk_app(f, "bash", ResourceSpec(slots=1, cpu_only=True),
                       retries, executor, retry_policy)
    return deco(fn) if fn is not None else deco
