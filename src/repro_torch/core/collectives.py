"""Collectives over a ``SubMesh`` — the counterparts of what the
reference's task bodies use from JAX: ``PartitionSpec``, ``shard_map``,
``jax.lax.psum`` and ``jax.lax.pmean``.

A body runs on every rank of its slot block (spmd_world.py).
``shard_map(fn, mesh, in_specs, out_specs)`` hands each rank its chunk of
every input sharded on an axis (dim ``d`` of ``P(..., axis, ...)`` split
evenly along that axis, the chunk at the rank's coordinate on it), runs
``fn`` on the chunks, and gathers each output sharded on an axis over that
axis's group; ``P()`` means replicated: the rank's value as it is.  Inside
``fn``, ``psum(x, axis)`` and ``pmean(x, axis)`` reduce over the axis's
group (an axis name, or a tuple of names for their product).

An axis of size 1 makes every collective the identity, which is how a
sub-mesh of one device runs in-process.  A collective over more than one
rank needs the sub-mesh's process groups, which only a pilot world gives
(``PilotDescription(ranks=N)``); without them it raises.  A collective the
backend lacks for the tensor's device (gloo with CUDA tensors, say) raises
and names the collective: nothing here copies a tensor to the host.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from .spmd_executor import AXIS_NAMES, SubMesh

Axis = Union[str, Tuple[str, ...]]

_active = threading.local()         # the sub-mesh of the enclosing shard_map


class P(tuple):
    """A partition spec: one entry per leading dim of a value, each None
    (not split), an axis name, or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _axes(axis: Axis) -> Tuple[str, ...]:
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    bad = [a for a in axes if a not in AXIS_NAMES]
    if bad or not axes:
        raise ValueError(f"axis {axis!r}: expected names from {AXIS_NAMES}")
    return axes


def axis_size(mesh: SubMesh, axis: Axis) -> int:
    n = 1
    for a in _axes(axis):
        n *= mesh.shape[AXIS_NAMES.index(a)]
    return n


def axis_index(mesh: SubMesh, axis: Axis) -> int:
    """This rank's index along ``axis`` (row-major over a tuple)."""
    idx = 0
    for a in _axes(axis):
        i = AXIS_NAMES.index(a)
        idx = idx * mesh.shape[i] + mesh.coords[i]
    return idx


def _mesh(mesh: Optional[SubMesh]) -> SubMesh:
    mesh = mesh if mesh is not None else getattr(_active, "mesh", None)
    if mesh is None:
        raise RuntimeError("a collective outside shard_map needs mesh=")
    return mesh


def _group(mesh: SubMesh, axes: Tuple[str, ...], what: str):
    """The process group of ``axes``, or None when they span one rank."""
    if axis_size(mesh, axes) == 1:
        return None
    if len(set(axes)) == len(AXIS_NAMES):
        group = mesh.group(None)
    elif len(axes) == 1:
        group = mesh.group(axes[0])
    else:
        raise ValueError(f"{what} over {axes}: repeated axis names")
    if group is None:
        raise RuntimeError(
            f"{what} over {axes} spans {axis_size(mesh, axes)} ranks and "
            f"{mesh} has no process group: collectives across ranks run "
            "on a pilot world (PilotDescription(ranks=N))")
    return group


def _call(what: str, fn: Callable, t: torch.Tensor, group):
    import torch.distributed as dist
    try:
        fn()
    except RuntimeError as e:
        raise RuntimeError(
            f"{what} on {t.device.type} {t.dtype} tensors over the "
            f"{dist.get_backend(group)} backend failed: {e}") from e


def _as_tensor(x, mesh: SubMesh) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, device=mesh.device)


def psum(x, axis: Axis, mesh: Optional[SubMesh] = None) -> torch.Tensor:
    """The sum of ``x`` over the ranks along ``axis`` (a new tensor)."""
    import torch.distributed as dist
    mesh = _mesh(mesh)
    x = _as_tensor(x, mesh)
    group = _group(mesh, _axes(axis), "psum")
    if group is None:
        return x
    y = x.clone()
    _call("psum (all_reduce)", lambda: dist.all_reduce(
        y, dist.ReduceOp.SUM, group=group), y, group)
    return y


def pmean(x, axis: Axis, mesh: Optional[SubMesh] = None) -> torch.Tensor:
    """The mean of ``x`` over the ranks along ``axis``."""
    mesh = _mesh(mesh)
    return psum(x, axis, mesh) / axis_size(mesh, axis)


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 0,
               mesh: Optional[SubMesh] = None) -> torch.Tensor:
    """The ranks' ``x`` along ``axis``, concatenated on ``dim`` in the
    order of their index on it."""
    import torch.distributed as dist
    mesh = _mesh(mesh)
    group = _group(mesh, _axes(axis), "all_gather")
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    _call("all_gather", lambda: dist.all_gather(parts, x, group=group), x,
          group)
    return torch.cat(parts, dim)


def _entries(spec, ndim: int, what: str):
    spec = P() if spec is None else spec
    if len(spec) > ndim:
        raise ValueError(f"{what} spec {spec} has more entries than the "
                         f"value's {ndim} dims")
    return [(d, e) for d, e in enumerate(spec) if e is not None]


def _shard(x, spec, mesh: SubMesh):
    if not isinstance(x, torch.Tensor):
        if spec:
            raise TypeError(f"in spec {spec} shards a "
                            f"{type(x).__name__}: shard tensors")
        return x
    for d, axis in _entries(spec, x.dim(), "in"):
        n = axis_size(mesh, axis)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of size {x.shape[d]} does not split "
                             f"into {n} along {axis!r}")
        size = x.shape[d] // n
        x = x.narrow(d, axis_index(mesh, axis) * size, size)
    return x


def _gather(x, spec, mesh: SubMesh):
    if not isinstance(x, torch.Tensor):
        if spec:
            raise TypeError(f"out spec {spec} gathers a "
                            f"{type(x).__name__}: return tensors")
        return x
    for d, axis in reversed(_entries(spec, x.dim(), "out")):
        x = all_gather(x, axis, d, mesh)
    return x


def _per_item(specs, n: int, what: str) -> Sequence:
    if isinstance(specs, P) or specs is None:
        return [specs] * n
    specs = list(specs)
    if len(specs) != n:
        raise ValueError(f"{len(specs)} {what} specs for {n} values")
    return specs


def shard_map(fn: Callable, mesh: SubMesh, in_specs, out_specs) -> Callable:
    """``fn`` run per rank on its chunks of the inputs, its outputs
    gathered by ``out_specs`` — ``jax.shard_map`` on a ``SubMesh``.
    ``in_specs`` is one ``P`` for every positional input or a sequence of
    them; ``out_specs`` one ``P`` for a single output or a sequence for a
    tuple of outputs."""
    def run(*args):
        local = [_shard(a, s, mesh) for a, s in
                 zip(args, _per_item(in_specs, len(args), "in"))]
        outer = getattr(_active, "mesh", None)
        _active.mesh = mesh
        try:
            out = fn(*local)
        finally:
            _active.mesh = outer
        if isinstance(out_specs, P) or out_specs is None:
            return _gather(out, out_specs, mesh)
        return type(out)(_gather(o, s, mesh) for o, s in
                         zip(out, _per_item(out_specs, len(out), "out")))
    return run
