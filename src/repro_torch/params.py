"""Carry weights and caches between the reference's layout and the port's.

The reference stacks each layer leaf ``(G, ...)`` per position ``j`` of the
layer period (``params["layers"][j]``, layer ``i = g * period + j``); the
port keeps one dict per layer (``params["layers"][i]``).  The trees on the
reference side are numpy arrays: a test converts them from and to JAX
arrays, so nothing here imports JAX.  Each leaf keeps its own dtype on the
way in: a bf16 mamba model keeps ``A_log``, ``D`` and ``dt_bias`` in float32,
as the reference does.  bfloat16 leaves leave the port as float32 arrays
(numpy has no bfloat16), which holds their values exactly.

The same conversions serve every tree of the params' structure: grads and
the AdamW moments (``opt_state_to_numpy``/``opt_state_from_numpy`` carry the
whole ``AdamState`` to and from the reference's ``(step, m, v)``).
``stack_layers``/``unstack_layers`` do the restacking on torch tensors, in
their dtype and on their device: the checkpointer saves model state in the
reference's layout through them.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.attention import AttnCache
from .models.mamba2 import MambaCache
from .models.transformer import program_period
from .optim import AdamState
from .tree import leaves, tree_map


def _to_tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' type, from JAX
        return torch.tensor(a.astype(np.float32), device=device).bfloat16()
    return torch.tensor(a, device=device)       # a copy: JAX's are read-only


def _to_numpy(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _groups(stacked):
    return leaves(stacked)[0].shape[0]


def stack_layers(params, cfg):
    """The port's per-layer tree -> the reference's layout, each layer leaf
    stacked (G, ...) per period position, as torch tensors."""
    out = {k: v for k, v in params.items() if k != "layers"}
    layers, period = params["layers"], program_period(cfg)
    out["layers"] = [tree_map(lambda *ts: torch.stack(ts), *layers[j::period])
                     for j in range(period)]
    return out


def unstack_layers(tree):
    """Inverse of :func:`stack_layers`: layer ``i = g * period + j`` is
    entry ``g`` of period position ``j`` (a view of the stacked tensor or
    array)."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    stacked = tree["layers"]
    period, groups = len(stacked), _groups(stacked[0])
    out["layers"] = [tree_map(lambda t: t[i // period], stacked[i % period])
                     for i in range(period * groups)]
    return out


def from_numpy_tree(tree, device=None):
    """The reference's ``init_params`` tree (as numpy) -> the port's params,
    each leaf in its own dtype."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, dev), unstack_layers(tree))


def to_numpy_tree(params, cfg):
    """The port's params -> the reference's stacked tree, as numpy."""
    return tree_map(_to_numpy, stack_layers(params, cfg))


def opt_state_to_numpy(state: AdamState, cfg):
    """The port's ``AdamState`` -> the reference's (step, m, v), as numpy."""
    return (np.asarray(state.step.item(), np.int32),
            to_numpy_tree(state.m, cfg), to_numpy_tree(state.v, cfg))


def opt_state_from_numpy(state, device=None) -> AdamState:
    """The reference's ``AdamState`` (step, m, v), as numpy -> the port's."""
    step, m, v = state
    return AdamState(torch.tensor(int(np.asarray(step)), dtype=torch.int32),
                     from_numpy_tree(m, device), from_numpy_tree(v, device))


def _cache_type(entry):
    """k and v of an attention layer are both (G, B, S, Hkv, D); a mamba
    layer's conv window (G, B, W-1, C) has one axis fewer than its h."""
    return AttnCache if np.ndim(entry[1]) == 5 else MambaCache


def cache_from_numpy(cache, device=None):
    """The reference's decode cache (per period position, (k, v) each
    (G, B, S, Hkv, D) or (h, conv) of (G, B, H, P, N) and (G, B, W-1, C), as
    numpy) -> the port's per-layer ``AttnCache``/``MambaCache`` list."""
    dev = resolve_device(device)
    period, groups = len(cache), np.asarray(cache[0][0]).shape[0]
    return [_cache_type(cache[i % period])(
                *(_to_tensor(np.asarray(a)[i // period], dev)
                  for a in cache[i % period]))
            for i in range(period * groups)]


def cache_to_numpy(cache, cfg):
    """The port's per-layer cache -> per period position, a tuple of its
    fields stacked (G, ...), as numpy."""
    period = program_period(cfg)
    return [tuple(np.stack([_to_numpy(c[n]) for c in cache[j::period]])
                  for n in range(len(cache[j])))
            for j in range(period)]
