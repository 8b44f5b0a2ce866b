"""Carry weights and caches between the reference's layout and the port's.

The reference stacks each layer leaf ``(G, ...)`` per position ``j`` of the
layer period (``params["layers"][j]``, layer ``i = g * period + j``); the
port keeps one dict per layer (``params["layers"][i]``).  The trees on the
reference side are numpy arrays: a test converts them from and to JAX
arrays, so nothing here imports JAX.  Each leaf keeps its own dtype on the
way in: a bf16 mamba model keeps ``A_log``, ``D`` and ``dt_bias`` in float32,
as the reference does.  bfloat16 leaves leave the port as float32 arrays
(numpy has no bfloat16), which holds their values exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.attention import AttnCache
from .models.mamba2 import MambaCache
from .models.transformer import program_period


def _to_tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' type, from JAX
        return torch.tensor(a.astype(np.float32), device=device).bfloat16()
    return torch.tensor(a, device=device)       # a copy: JAX's are read-only


def _to_numpy(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _groups(stacked):
    while isinstance(stacked, dict):
        stacked = next(iter(stacked.values()))
    return np.asarray(stacked).shape[0]


def from_numpy_tree(tree, device=None):
    """The reference's ``init_params`` tree (as numpy) -> the port's params,
    each leaf in its own dtype."""
    dev = resolve_device(device)
    conv = lambda a: _to_tensor(a, dev)
    out = {k: _map(conv, v) for k, v in tree.items() if k != "layers"}
    stacked = tree["layers"]
    period, groups = len(stacked), _groups(stacked[0])
    out["layers"] = [
        _map(lambda a: conv(np.asarray(a)[i // period]), stacked[i % period])
        for i in range(period * groups)]
    return out


def to_numpy_tree(params, cfg):
    """The port's params -> the reference's stacked tree, as numpy."""
    out = {k: _map(_to_numpy, v) for k, v in params.items() if k != "layers"}
    layers = [_map(_to_numpy, layer) for layer in params["layers"]]
    period = program_period(cfg)
    out["layers"] = [_stack(layers[j::period]) for j in range(period)]
    return out


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
