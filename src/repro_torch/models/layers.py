"""Shared layer primitives: RMSNorm, RoPE, MLP, softcap.

Port of ``repro.models.layers``; each function keeps the reference's
rounding points so that bf16 runs agree with it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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

def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                       # (D/2,)
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

def mlp(x, w, gated: bool):
    """w: {'wi': (D,F), 'wg': (D,F) if gated, 'wo': (F,D)}."""
    h = x @ w["wi"]
    if gated:
        h = F.silu(x @ w["wg"]) * h
    else:
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    return h @ w["wo"]
