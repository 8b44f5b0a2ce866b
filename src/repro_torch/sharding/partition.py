"""Logical-axis -> physical-mesh partitioning, on ``torch.distributed``.

Port of ``repro.sharding.partition``: weights and activations are annotated
with *logical* axis names, and this module resolves them against a mesh,
with the reference's divisibility fallback (smollm's 15 query heads cannot
shard 16 ways -> replicated; granite's 49155 vocab rows cannot shard 16
ways -> the embedding falls back to FSDP only).  The rule table is a copy
of the reference's, so both packages make the same decisions.

A spec is a tuple in the reference's ``PartitionSpec`` form: one entry per
tensor dim, each ``None``, a mesh axis name or a tuple of names, trailing
``None`` entries dropped.  ``spec_for`` reads only ``mesh.shape``-like
mappings (a ``DeviceMesh`` is read through :func:`mesh_shape`), so a test
can resolve specs for a mesh it does not have.  :func:`placements_for`
turns a spec into DTensor placements on a ``DeviceMesh``: ``Shard(dim)``
on each mesh dim that the spec names, ``Replicate()`` on the others.  A
spec entry of two axes, such as ``("pod", "data")``, shards one tensor dim
over two mesh dims, the first named the outer.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

# logical axis -> ordered candidate mesh axes (first divisible wins; the
# batch/fsdp axis composes pod+data when a pod axis exists).
DEFAULT_RULES: Dict[Optional[str], Tuple[Tuple[str, ...], ...]] = {
    "batch":    (("pod", "data"), ("data",)),
    "embed_w":  (("pod", "data"), ("data",)),   # weight FSDP axis (ZeRO-3)
    "vocab":    (("model",),),
    "heads":    (("model",),),
    "kv_heads": (("model",),),
    "mlp":      (("model",),),
    "expert":   (("model",),),
    "ssm_heads": (("model",),),
    "ssm_inner": (("model",),),
    "expert_embed": (("pod", "data"), ("data",)),
    "expert_ff": ((),),
    "seq_kv":   (("data",),),                    # long-context decode KV shard
    "seq":      ((),),                           # train seq: unsharded
    "embed":    ((),),                           # activation d_model: unsharded
    "head_dim": (("model",),),                   # fallback TP when heads can't
    "layers":   ((),),
    "state":    ((),),
    None:       ((),),
}

Spec = Tuple


def mesh_shape(mesh) -> Mapping[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, or the mapping itself."""
    if isinstance(mesh, Mapping):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry: () for None, (a,) for a name."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class PartitionRules:
    def __init__(self, rules: Optional[Dict] = None):
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)

    @staticmethod
    def _axis_size(shape: Mapping[str, int], axes: Tuple[str, ...]) -> int:
        n = 1
        for a in axes:
            n *= shape[a]
        return n

    def spec_for(self, logical: Sequence[Optional[str]], shape: Sequence[int],
                 mesh) -> Spec:
        """The spec of a tensor of ``shape`` whose dims are named
        ``logical``: each dim takes the first candidate of its rule whose
        axes are in the mesh, unused by an earlier dim, of size > 1, and
        divide the dim."""
        ms = mesh_shape(mesh)
        used = set()
        out = []
        for name, dim in zip(logical, shape):
            resolved = None
            for cand in self.rules.get(name, ((),)):
                cand = tuple(a for a in cand if a in ms)
                if not cand or any(a in used for a in cand):
                    continue
                sz = self._axis_size(ms, cand)
                if sz > 1 and dim % sz == 0:
                    resolved = cand if len(cand) > 1 else cand[0]
                    used.update(cand)
                    break
            out.append(resolved)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def placements_for(self, logical, shape, mesh):
        return placements_for(self.spec_for(logical, shape, mesh), mesh)

    def tree_specs(self, axes_tree, shape_tree, mesh):
        """A tree of logical-axes tuples and a matching tree of tensors (or
        anything with ``.shape``) -> a tree of specs."""
        return tree_specs(self, axes_tree, shape_tree, mesh)


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_specs(rules: PartitionRules, axes_tree, shape_tree, mesh):
    """Map a tree of logical-axes tuples and the matching tree of shaped
    leaves to specs (dicts, lists and NamedTuples, as ``jax.tree``)."""
    if _is_axes_leaf(axes_tree):
        return rules.spec_for(axes_tree, shape_tree.shape, mesh)
    if isinstance(axes_tree, dict):
        return {k: tree_specs(rules, v, shape_tree[k], mesh)
                for k, v in axes_tree.items()}
    items = [tree_specs(rules, a, s, mesh)
             for a, s in zip(axes_tree, shape_tree)]
    if hasattr(axes_tree, "_fields"):
        return type(axes_tree)(*items)
    return type(axes_tree)(items)


def placements_for(spec: Spec, mesh):
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``: one
    per mesh dim, ``Shard(d)`` where tensor dim ``d``'s entry names that
    mesh dim, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in spec_axes(entry):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def _grad_placements(inp, outs):
    """Where an input is replicated on a mesh dim across which the outputs
    are split, each rank's gradient is its own share of the whole: a
    partial sum over that dim (the transpose of a replicated input in the
    reference's ``shard_map``).  Elsewhere the gradient is placed as the
    input."""
    from torch.distributed.tensor import Partial, Replicate
    out = []
    for i, p in enumerate(inp):
        split = any(not isinstance(o[i], Replicate) for o in outs)
        out.append(Partial() if isinstance(p, Replicate) and split else p)
    return tuple(out)


def local_region(fn, mesh, args, in_placements, out_placements):
    """``fn`` on the local shards of the DTensors ``args`` (the reference's
    ``shard_map``): each argument is redistributed to its entry of
    ``in_placements``, ``fn`` runs on the local tensors, and its output
    (one tensor, or a tuple matching a tuple of placements) comes back as
    DTensors with ``out_placements``.  Gradients flow through it, partial
    sums where :func:`_grad_placements` says so."""
    from torch.distributed.tensor.experimental import local_map
    multi = isinstance(out_placements[0], tuple)
    outs = out_placements if multi else (out_placements,)
    return local_map(
        fn, out_placements=outs, in_placements=tuple(in_placements),
        in_grad_placements=tuple(_grad_placements(p, outs)
                                 for p in in_placements),
        device_mesh=mesh, redistribute_inputs=True)(*args)


class ShardCtx:
    """Carries (mesh, rules) into model code; ``act`` places activations.

    With ``mesh is None`` (one device, the CPU tests) every ``act`` is the
    identity, so the model code is written once and the unsharded path
    runs exactly as it would without it.  With a ``DeviceMesh``, ``act``
    redistributes a DTensor to the placements its logical axes resolve to,
    and in the backward its gradient likewise, as the reference's
    ``with_sharding_constraint`` constrains both.
    """

    def __init__(self, mesh, rules: Optional[PartitionRules] = None):
        self.mesh = mesh
        self.rules = rules or PartitionRules()

    def act(self, x, logical: Sequence[Optional[str]]):
        if self.mesh is None:
            return x
        return x.redistribute(self.mesh, self.rules.placements_for(
            logical, x.shape, self.mesh))

    def spec(self, logical, shape) -> Spec:
        if self.mesh is None:
            return ()
        return self.rules.spec_for(logical, shape, self.mesh)

    def placements(self, logical, shape):
        return self.rules.placements_for(logical, shape, self.mesh)


NULL_CTX = ShardCtx(None)
