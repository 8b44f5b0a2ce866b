"""Weights and batches drawn from a seed, the same for the program and the
reference.

A family's reference module lists every weight as (path, shape, init)
(``leaves``); :func:`draw` makes them on the device from ``--seed`` in a
few large calls: one normal draw in the model's type for every matrix and
vector (then each scaled by 1/sqrt(fan_in), or zeroed for a norm's delta),
one uniform draw in float32 for Mamba2's per-head dt and A (Mamba2's
published init: dt log-uniform in [1e-3, 0.1], A uniform in [1, 16], D
ones).  Two flat buffers hold them all, so a copy of the whole set is two
calls.
"""
from __future__ import annotations

import math

import numpy as np
import torch

F32_INITS = ("dt_bias", "A_log", "ones")
SEED_MASK = (1 << 63) - 1


class Weights:
    """The drawn weights: ``flat`` (model type) and ``flat32`` (float32)
    buffers, and ``views``, path -> a view of one of them."""

    def __init__(self, leaves, flat, flat32):
        self.leaves, self.flat, self.flat32 = leaves, flat, flat32
        self.views = {}
        off = {False: 0, True: 0}
        for path, shape, init in leaves:
            f32 = init[0] in F32_INITS
            n = math.prod(shape)
            buf = flat32 if f32 else flat
            self.views[path] = buf[off[f32]:off[f32] + n].view(shape)
            off[f32] += n

    def clone(self):
        return Weights(self.leaves, self.flat.clone(), self.flat32.clone())

    def stores(self):
        """path -> the type the program keeps that leaf in."""
        return {p: v.dtype for p, v in self.views.items()}

    def tree(self):
        """The program's nested params: "a.3.b" -> tree["a"][3]["b"]."""
        root = {}
        for path, v in self.views.items():
            parts = path.split(".")
            node = root
            for j, key in enumerate(parts[:-1]):
                nxt = [] if parts[j + 1].isdigit() else {}
                if isinstance(node, list):
                    k = int(key)
                    while len(node) <= k:
                        node.append(None)
                    if node[k] is None:
                        node[k] = nxt
                    node = node[k]
                else:
                    node = node.setdefault(key, nxt)
            node[parts[-1]] = v
        return root


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed & SEED_MASK)


@torch.no_grad()
def draw(leaves, seed: int, device, dtype) -> Weights:
    n = sum(math.prod(s) for _, s, i in leaves if i[0] not in F32_INITS)
    n32 = sum(math.prod(s) for _, s, i in leaves if i[0] in F32_INITS)
    gen = generator(seed, device)
    flat = torch.randn(n, generator=gen, device=device, dtype=dtype)
    flat32 = torch.rand(n32, generator=gen, device=device,
                        dtype=torch.float32)
    w = Weights(leaves, flat, flat32)
    lo, hi = math.log(1e-3), math.log(1e-1)
    for path, _, init in leaves:
        v = w.views[path]
        if init[0] == "normal":
            v.mul_(1.0 / math.sqrt(init[1]))
        elif init[0] == "zeros":
            v.zero_()
        elif init[0] == "dt_bias":
            dt = torch.exp(lo + (hi - lo) * v)
            v.copy_(dt + torch.log(-torch.expm1(-dt)))
        elif init[0] == "A_log":
            v.copy_(torch.log(1.0 + 15.0 * v))
        elif init[0] == "ones":
            v.fill_(1.0)
        else:
            raise ValueError(f"{path}: init {init!r}")
    return w


def tokens(seed: int, stream: int, index: int, shape, vocab: int):
    """Token ids (int64, numpy) of one batch or document: ``stream`` tells
    apart the uses of one seed (training steps, held-out batches,
    documents), ``index`` the batch within it."""
    rng = np.random.default_rng([seed & SEED_MASK, stream, index])
    return rng.integers(0, vocab, size=shape, dtype=np.int64)
