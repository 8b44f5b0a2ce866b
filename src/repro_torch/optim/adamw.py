"""AdamW with global-norm clipping, bias correction and a cosine schedule.

Port of ``repro.optim.adamw``: the same update in f32 math, moments stored
in ``state_dtype``.  Under a mesh the params and grads are DTensors: the
moments take their leaf's placements, the global norm is taken over the
whole of each leaf (a sum over its shards), and the update, elementwise,
runs on each rank's local shards (params, grads and moments share their
placements).  The port updates params and
moments in place (under ``torch.no_grad``) and returns them; the reference
returns new arrays.  The reference chains its leaf updates through
``optimization_barrier`` so that XLA keeps one leaf's f32 temporaries live
at a time; eager PyTorch runs the leaves one after another anyway, and
walks a large leaf in flat slices (``_pieces``): an MoE expert leaf of
qwen3-moe is 805 M elements, and the update's half-dozen f32 temporaries
of it whole would take some 20 GB.  Each element sees the same arithmetic
either way.
``abstract_state`` and ``state_axes`` serve the dry-run: the moments as
``meta`` tensors, the step a real host tensor (``update`` reads it on the
host), and their logical axes.

Decoupled weight decay applies where the reference's leaf has two or more
dimensions.  The reference stacks each layer leaf as (G, ...), so a layer's
norm scale is a matrix there and decays, while ``final_norm`` does not; the
port's per-layer leaves lack that axis, so a leaf under ``"layers"`` counts
it (ROADMAP queue 3).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from ..device import torch_dtype
from ..tree import flatten, tree_map, unflatten


_SLICE = 1 << 26        # elements of a leaf updated at once


def _pieces(*ts):
    """Flat slices of at most ``_SLICE`` elements of each of ``ts`` (one
    shape), or the whole tensors where one is not contiguous."""
    n = ts[0].numel()
    if n <= _SLICE or not all(t.is_contiguous() for t in ts):
        yield ts
        return
    flat = [t.view(-1) for t in ts]
    for i in range(0, n, _SLICE):
        yield tuple(f[i:i + _SLICE] for f in flat)


def _whole(t):
    """A DTensor's value as a plain tensor (its shards' partial sums
    reduced); a plain tensor as is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _locals(p, *others):
    """The local shards of a DTensor leaf and of its grad and moments,
    which must share its placements; plain tensors as they are."""
    if not hasattr(p, "to_local"):
        return (p,) + others
    if any(o.placements != p.placements for o in others):
        raise ValueError(f"AdamW: grad or moments placed {[o.placements for o in others]}, "
                         f"their param {p.placements}")
    return tuple(t.to_local() for t in (p,) + others)


class AdamState(NamedTuple):
    step: torch.Tensor     # int32 scalar, on the host
    m: Any
    v: Any


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """step -> learning rate, an f32 scalar tensor, as the reference
    computes it in f32: linear warm-up, then cosine decay to 0."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(1, warmup)
        prog = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


def _layer_flags(tree):
    """For each leaf in flatten order: does it sit under "layers"?"""
    if isinstance(tree, dict):
        flags = []
        for k in sorted(tree):
            sub = _layer_flags(tree[k])
            flags += [True] * len(sub) if k == "layers" else sub
        return flags
    if isinstance(tree, (list, tuple)):
        return [f for c in tree for f in _layer_flags(c)]
    return [False]


@dataclass(frozen=True)
class AdamW:
    lr: Callable = cosine_schedule(3e-4, 100, 10_000)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"

    def init(self, params) -> AdamState:
        dt = torch_dtype(self.state_dtype)
        zeros = lambda p: torch.zeros_like(p, dtype=dt)
        return AdamState(torch.zeros((), dtype=torch.int32),
                         tree_map(zeros, params), tree_map(zeros, params))

    def abstract_state(self, abstract_params) -> AdamState:
        """The state of :meth:`init` for params given as ``meta`` tensors:
        the moments ``meta`` tensors in ``state_dtype``, the step a real
        int32 host tensor, since :meth:`update` reads it on the host."""
        dt = torch_dtype(self.state_dtype)
        meta = lambda p: torch.empty(p.shape, dtype=dt, device="meta")
        return AdamState(torch.zeros((), dtype=torch.int32),
                         tree_map(meta, abstract_params),
                         tree_map(meta, abstract_params))

    def state_axes(self, axes_tree) -> AdamState:
        """Logical axes of the state: the step has none, each moment its
        param's."""
        return AdamState((), axes_tree, axes_tree)

    @torch.no_grad()
    def update(self, params, grads, state: AdamState):
        """One step.  Returns (params, state, grad norm before clipping);
        params and moments are the given tensors, updated in place."""
        flat_p, structure = flatten(params)
        flat_g = flatten(grads)[0]
        flat_m, flat_v = flatten(state.m)[0], flatten(state.v)[0]
        gnorm = torch.sqrt(sum(_whole(g.float().square().sum())
                               for g in flat_g))
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        step = state.step + 1
        stepf = step.float()
        lr = float(self.lr(step))
        b1, b2 = self.b1, self.b2
        bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** stepf)
        bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** stepf)
        for leaf, grad, mom, var, stacked in zip(
                flat_p, flat_g, flat_m, flat_v, _layer_flags(params)):
            decay = leaf.dim() + stacked >= 2   # decoupled decay on matrices
            for p, g, m, v in _pieces(*_locals(leaf, grad, mom, var)):
                g = g.float() * scale
                m32 = b1 * m.float() + (1 - b1) * g
                v32 = b2 * v.float() + (1 - b2) * g.square()
                upd = (m32 / bc1) / (torch.sqrt(v32 / bc2) + self.eps)
                if decay:
                    upd = upd + self.weight_decay * p.float()
                p.copy_(p.float() - lr * upd)
                m.copy_(m32)
                v.copy_(v32)
        return unflatten(structure, flat_p), AdamState(step, state.m, state.v), gnorm
