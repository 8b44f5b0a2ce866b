"""Carry weights and caches between the reference's layout and the port's.

The reference stacks each layer leaf ``(G, ...)`` per position ``j`` of the
layer period (``params["layers"][j]``, layer ``i = g * period + j``); the
port keeps one dict per layer (``params["layers"][i]``).  The trees on the
reference side are numpy arrays: a test converts them from and to JAX
arrays, so nothing here imports JAX.  bfloat16 leaves leave the port as
float32 arrays (numpy has no bfloat16), which holds their values exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device, torch_dtype
from .models.attention import AttnCache
from .models.transformer import program_period


def _to_tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' type, from JAX
        a = a.astype(np.float32)
    t = torch.tensor(a, device=device)          # a copy: JAX's are read-only
    return t if dtype is None else t.to(torch_dtype(dtype))


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


def from_numpy_tree(tree, device=None, dtype=None):
    """The reference's ``init_params`` tree (as numpy) -> the port's params."""
    dev = resolve_device(device)
    conv = lambda a: _to_tensor(a, dev, dtype)
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


def cache_from_numpy(cache, device=None, dtype=None):
    """The reference's decode cache ([(k, v)] per period position, each
    (G, B, S, Hkv, D), as numpy) -> the port's per-layer ``AttnCache`` list."""
    dev = resolve_device(device)
    period, groups = len(cache), np.asarray(cache[0][0]).shape[0]
    return [AttnCache(*(_to_tensor(np.asarray(a)[i // period], dev, dtype)
                        for a in cache[i % period]))
            for i in range(period * groups)]


def cache_to_numpy(cache, cfg):
    """The port's per-layer cache -> [(k, v) stacked (G, ...)] per period
    position, as numpy."""
    period = program_period(cfg)
    return [tuple(np.stack([_to_numpy(c[n]) for c in cache[j::period]])
                  for n in range(2))
            for j in range(period)]
