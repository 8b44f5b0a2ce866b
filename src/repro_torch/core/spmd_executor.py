"""SPMD function executor — the paper's MPI-function-executor, on torch
devices.

The paper's executor launches one persistent MPI world, then carves
Intra-communicators so many heterogeneous MPI Python functions run
concurrently.  Here a pilot runs its ``spmd`` tasks one of two ways:

* in-process (``PilotDescription.ranks == 0``, the default): the body runs
  in the agent's process on the sub-mesh's devices.  Its ``SubMesh`` has
  no process group, so a collective over more than one rank raises.
* on a world (``ranks == N``): ``SPMDWorld`` (spmd_world.py) keeps N rank
  processes joined in one ``torch.distributed`` world for the pilot's
  life.  A slot block maps to a set of ranks; every rank of the block
  runs the body on a ``SubMesh`` that carries the block's process groups
  (the whole block and one per mesh axis, created once and cached: the
  Intra-communicator) and their ``DeviceMesh``.  Bodies reduce with
  ``collectives.shard_map``/``psum``/``pmean`` or hand
  ``mesh.device_mesh`` to the model's ``ShardCtx``.

The paper's §V-A performance lesson — *build the communicator once, reuse
it, cache it* — is structural here: sub-meshes and specialized callables are
cached keyed by (function, sub-mesh).  The first dispatch of a key pays the
specialization (with ``jit``, the ``torch.compile`` wrapper, in-process or
in each rank of a world; on a world also the ranks' group creation; the
paper's `Launching`/`ibrun` analog); every subsequent task with the same
key is a cheap cached call.  On a world the parent keeps the key's count
and sends the key with the task, and each rank keeps its compiled wrapper
under it (spmd_world.py).  The ``cache=False`` mode exists only for the
ablation that reproduces the paper's cold-communicator overhead: every
task then compiles anew and, on a world, creates its block's groups anew
(and the ranks destroy them after it).

Slots may outnumber devices or ranks (one card, or the CPU in tests): slot
``s`` maps to device (or rank) ``s % N``, dedup'd, preserving scheduling
semantics while executing on what exists.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..tree import leaves
from .futures import TaskRecord

AXIS_NAMES = ("data", "model")


class SubMesh:
    """A slot block's devices as a (data, model) grid — the cached
    "Intra-communicator".  Immutable: the executor hands one instance to
    every task of the same slot block and shape.

    ``rank`` is this process's position in the block (row-major over
    ``shape``) and ``ranks`` the block's world ranks.  On a world,
    ``groups`` holds the block's process groups: ``None`` for the whole
    block and one per axis name, each the group through this rank.
    ``state`` is a dict in which the block's bodies may keep what later
    tasks on it need: the executor (on a world, each rank) keeps one per
    block, whether or not it caches the block's groups."""

    __slots__ = ("devices", "shape", "axis_names", "rank", "ranks",
                 "state", "_groups", "_device_mesh")

    def __init__(self, devices: Sequence[torch.device],
                 shape: Tuple[int, int], *, rank: int = 0,
                 ranks: Optional[Sequence[int]] = None,
                 groups: Optional[Dict[Optional[str], Any]] = None,
                 state: Optional[dict] = None):
        if shape[0] * shape[1] != len(devices):
            raise ValueError(f"mesh shape {shape} does not hold "
                             f"{len(devices)} devices")
        ranks = tuple(range(len(devices)) if ranks is None else ranks)
        if len(ranks) != len(devices) or not 0 <= rank < len(ranks):
            raise ValueError(f"rank {rank} of ranks {ranks} does not fit "
                             f"{len(devices)} devices")
        object.__setattr__(self, "devices", tuple(devices))
        object.__setattr__(self, "shape", tuple(shape))
        object.__setattr__(self, "axis_names", AXIS_NAMES)
        object.__setattr__(self, "rank", rank)
        object.__setattr__(self, "ranks", ranks)
        object.__setattr__(self, "state", {} if state is None else state)
        object.__setattr__(self, "_groups", groups)
        object.__setattr__(self, "_device_mesh", None)

    def __setattr__(self, name, value):
        raise AttributeError("SubMesh is immutable")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """This rank's device: where a body puts its tensors."""
        return self.devices[self.rank]

    @property
    def coords(self) -> Tuple[int, int]:
        """This rank's (data, model) position in the block."""
        return divmod(self.rank, self.shape[1])

    def group(self, axis: Optional[str] = None):
        """The process group of ``axis`` through this rank, or of the whole
        block for ``axis=None``; None in-process (no world)."""
        if self._groups is None:
            return None
        return self._groups[axis]

    @property
    def device_mesh(self):
        """The block as a ``DeviceMesh`` over its cached groups, with the
        dim names ("data", "model"): what ``ShardCtx`` takes."""
        if self._groups is None:
            raise RuntimeError("this sub-mesh has no process group: a "
                               "DeviceMesh needs a pilot world "
                               "(PilotDescription(ranks=N))")
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh
            object.__setattr__(self, "_device_mesh", DeviceMesh.from_group(
                [self._groups["data"], self._groups["model"]],
                self.device.type,
                mesh=torch.tensor(self.ranks).reshape(self.shape),
                mesh_dim_names=AXIS_NAMES))
        return self._device_mesh

    def key(self) -> Tuple:
        return (self.ranks, tuple(str(d) for d in self.devices), self.shape)

    def __repr__(self):
        return (f"SubMesh(ranks {self.ranks} on "
                f"{', '.join(str(d) for d in self.devices)}; "
                f"{dict(zip(self.axis_names, self.shape))})")


def single_device_mesh(device: torch.device) -> SubMesh:
    """The one-device sub-mesh on ``device``."""
    return SubMesh((torch.device(device),), (1, 1))


class SPMDFunctionExecutor:
    def __init__(self, devices: Sequence[torch.device], cache: bool = True,
                 world=None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("SPMDFunctionExecutor needs at least one device")
        self.cache_enabled = cache
        self.world = world              # SPMDWorld, or None: in-process
        self._mesh_cache: Dict[Tuple, SubMesh] = {}
        self._call_cache: Dict[Tuple, Callable] = {}
        self._states: Dict[Tuple, dict] = {}      # each block's ``state``
        self._lock = threading.Lock()
        self.stats = {"compiles": 0, "cache_hits": 0}

    # ----------------------------- sub-mesh ----------------------------- #
    def submesh(self, slot_ids: Tuple[int, ...],
                mesh_shape: Optional[Tuple[int, int]] = None) -> SubMesh:
        """Carve the sub-mesh ('Intra-communicator') for a slot block: slot
        ``s`` takes device ``s % len(devices)``, or on a world rank ``s %
        N`` (the block's ranks sorted, so every rank orders them alike)."""
        if self.world is not None:
            ranks = sorted({s % self.world.n for s in slot_ids})
            units = ranks
        else:
            units = []
            for s in slot_ids:
                d = self.devices[s % len(self.devices)]
                if d not in units:
                    units.append(d)
        n = len(units)
        if mesh_shape and mesh_shape[0] * mesh_shape[1] <= n:
            shape = tuple(mesh_shape)
        else:
            shape = (n, 1)
        units = units[: shape[0] * shape[1]]
        if self.world is not None:
            mesh = SubMesh([self.world.rank_devices[r] for r in units], shape,
                           ranks=units)
        else:
            mesh = SubMesh(units, shape)
        with self._lock:
            state = self._states.setdefault(mesh.key(), mesh.state)
            if not self.cache_enabled:
                return SubMesh(mesh.devices, shape, ranks=mesh.ranks,
                               state=state)
            return self._mesh_cache.setdefault(mesh.key(), mesh)

    # ----------------------------- dispatch ----------------------------- #
    def _specialize(self, fn: Callable, mesh: SubMesh, jit: bool):
        """One specialized callable per (fn, mesh) — the communicator
        cache.  With ``jit`` the body is wrapped once in ``torch.compile``
        (which compiles at its first call)."""
        key = (id(fn), mesh.key(), jit)
        with self._lock:
            if self.cache_enabled and key in self._call_cache:
                self.stats["cache_hits"] += 1
                return self._call_cache[key]
        if self.world is not None:
            # the ranks build (and cache) the block's groups and call the
            # body; the parent keeps the key's count
            wrapped = fn
        elif jit:
            body = torch.compile(fn)
            wrapped = lambda *a, **kw: body(mesh, *a, **kw)  # noqa: E731
        else:
            wrapped = lambda *a, **kw: fn(mesh, *a, **kw)  # noqa: E731
        with self._lock:
            # double-checked: a concurrent miss may have registered first —
            # reuse its callable so both share one compiled body
            if self.cache_enabled and key in self._call_cache:
                self.stats["cache_hits"] += 1
                return self._call_cache[key]
            self.stats["compiles"] += 1
            if self.cache_enabled:
                self._call_cache[key] = wrapped
        return wrapped

    def execute(self, task: TaskRecord) -> Any:
        """Run a task body on its allocated slots.  Blocking; called from an
        agent worker thread (the MPI-Worker analog).  A result that holds
        CUDA tensors is complete on the device when this returns."""
        kwargs = dict(task.kwargs)
        # a checkpointable body's context cannot be traced, so the
        # wrapper-level compile is skipped: step bodies manage their own
        jit = kwargs.pop("_jit", True) and task.ckpt_ctx is None
        if task.kind == "spmd" and self.world is not None:
            mesh = self.submesh(task.slot_ids, task.resources.mesh_shape)
            self._specialize(task.fn, mesh, jit)
            # its tensors stay on the ranks: the parent gets RankRefs.  The
            # ranks compile the body under the parent's key
            return self.world.run(
                task.fn, task.args, kwargs, mesh.ranks, mesh.shape,
                uid=task.uid, ckpt=task.ckpt_ctx, cache=self.cache_enabled,
                compile_key=(id(task.fn), mesh.key()) if jit else None)
        if task.ckpt_ctx is not None:
            kwargs["ckpt"] = task.ckpt_ctx      # the live Checkpoint context
        if task.kind == "spmd":
            mesh = self.submesh(task.slot_ids, task.resources.mesh_shape)
            call = self._specialize(task.fn, mesh, jit)
            out = call(*task.args, **kwargs)
        else:  # plain python / bash-wrapped function: single slot
            out = task.fn(*task.args, **kwargs)
        for dev in _cuda_devices(out):
            torch.cuda.synchronize(dev)
        return out


def _cuda_devices(x) -> set:
    """The CUDA devices of the tensors among a result's leaves."""
    return {t.device for t in leaves(x)
            if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
