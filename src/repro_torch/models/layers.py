"""Shared layer primitives: RMSNorm, RoPE, MLP, softcap.

Port of ``repro.models.layers``; each function keeps the reference's
rounding points so that bf16 runs agree with it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sharding.partition import NULL_CTX, local_region


def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm with an f32 reduction; the scale ``rsqrt(var+eps)*(1+w)`` is
    cast to ``x.dtype`` before the multiply (a bf16 rounding point), and the
    weight is stored as a delta from 1."""
    var = x.square().float().mean(dim=-1, keepdim=True)
    scale = (torch.rsqrt(var + eps) * (1.0 + weight.float())).to(x.dtype)
    return x * scale


def softcap(x, cap: float):
    """Gemma2-style logit soft capping."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# ------------------------------ RoPE ---------------------------------- #
# Interleaved (even/odd pair) rotary embedding, as in the reference: pairs
# are adjacent in the head_dim axis (not the half-split form).

def rope_freqs(head_dim: int, theta: float, device=None, *, start: int = 0,
               count=None):
    """The frequencies of dims ``start``, ``start + 2``, ... of a head of
    ``head_dim`` (``count`` of them, all by default)."""
    count = head_dim if count is None else count
    exps = torch.arange(start, start + count, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float, *, start: int = 0, head_dim=None):
    """x: (..., S, H, D); positions: broadcastable to (..., S).  ``x`` may
    hold dims ``start``... of heads of ``head_dim`` (a shard of the head
    dim; ``start`` even)."""
    d = x.shape[-1]
    freqs = rope_freqs(head_dim or d, theta, x.device, start=start,
                       count=d)                                  # (D/2,)
    angles = positions[..., None].float() * freqs                # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


# ------------------------------ MLP ----------------------------------- #

def mlp(x, w, gated: bool, sctx=NULL_CTX):
    """w: {'wi': (D,F), 'wg': (D,F) if gated, 'wo': (F,D)}.  Under a mesh
    each rank's local products (:func:`sharded_mlp`)."""
    if sctx.mesh is not None:
        return sharded_mlp(x, w, gated)
    h = x @ w["wi"]
    if gated:
        h = F.silu(x @ w["wg"]) * h
    else:
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    return h @ w["wo"]


def sharded_mlp(x, w, gated: bool):
    """:func:`mlp` on DTensors in a ``local_map`` region: x (B, S, D) keeps
    its batch split, each weight is gathered on D (its FSDP axis) and keeps
    its split of F, and the output is a partial sum where F is split.  The
    weights' gradients come back as partial sums over the batch's mesh
    dims, which the caller places as the weights.  (DTensor's own matmuls
    gathered the batch's activations for the weights' gradients.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard
    names = ["wi", "wg", "wo"] if gated else ["wi", "wo"]
    rep = Replicate()
    x_pl = tuple(p if p == Shard(0) else rep for p in x.placements)
    f_dims = [i for i, p in enumerate(w["wi"].placements) if p == Shard(1)]
    w_pl = {n: tuple(Shard(1 if n != "wo" else 0) if i in f_dims else rep
                     for i in range(len(x_pl))) for n in names}
    out_pl = tuple(Partial() if i in f_dims else x_pl[i]
                   for i in range(len(x_pl)))

    def body(x_, *ws):
        return mlp(x_, dict(zip(names, ws)), gated)
    return local_region(body, x.device_mesh, (x, *(w[n] for n in names)),
                        (x_pl, *(w_pl[n] for n in names)), out_pl)
