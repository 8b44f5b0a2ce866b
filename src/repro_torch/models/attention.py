"""GQA attention: flash prefill through the kernel + KV-cache decode.

Port of the unsharded paths of ``repro.models.attention``.  The prefill
(no-cache) branch always goes through ``ops.flash_attention``, so a CUDA
run launches the flash-attention kernel and a CPU run takes its plain
version.  Not ported yet: ``blockwise_attention`` with its custom VJP
(training, ROADMAP K1b) and the sharded wrappers (ROADMAP queue 1 item 13).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels import ops
from .layers import apply_rope, softcap

NEG_INF = -1e30


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0,
                     attn_softcap: float = 0.0):
    """Single-token attention against a cache.

    q: (B, 1, Hq, D); caches: (B, S, Hkv, D); pos: index of the new token
    (the cache already holds it at ``pos``).
    """
    B, _, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(),
                     k_cache.float()) * (D ** -0.5)
    if attn_softcap:
        s = softcap(s, attn_softcap)
    kv_pos = torch.arange(S, device=q.device)
    mask = kv_pos <= pos
    if window:
        mask &= kv_pos > (pos - window)
    s = torch.where(mask[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def attn_params_spec(cfg):
    d, Hq, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": ((d, Hq, hd), ("embed_w", "heads", "head_dim")),
        "wk": ((d, Hkv, hd), ("embed_w", "kv_heads", "head_dim")),
        "wv": ((d, Hkv, hd), ("embed_w", "kv_heads", "head_dim")),
        "wo": ((Hq, hd, d), ("heads", "head_dim", "embed_w")),
    }


class AttnCache(NamedTuple):
    k: torch.Tensor       # (B, S, Hkv, D)
    v: torch.Tensor


def _project(x, w):
    """x (B,S,d) @ w (d,H,hd) -> contiguous (B,S,H,hd)."""
    d, H, hd = w.shape
    return (x @ w.reshape(d, H * hd)).view(*x.shape[:-1], H, hd)


def attention_layer(cfg, w, x, *, local: bool, positions=None,
                    cache: Optional[AttnCache] = None, pos=None,
                    use_pallas: bool = False):
    """Pre-norm attention mixer.  Returns (out, new_cache).

    Prefill: cache is None -> flash attention over x itself; the produced
    K/V are returned as the new cache.  Decode: cache given, x is (B, 1, D),
    ``pos`` the write index; K/V are written into the given cache in place
    (the reference returns an updated copy) and that cache is returned.
    ``use_pallas`` keeps the reference's signature and changes nothing: the
    prefill always goes through ``ops.flash_attention``.
    """
    window = cfg.sliding_window if local else 0
    B, S, _ = x.shape
    q = _project(x, w["wq"])
    kx = _project(x, w["wk"])
    vx = _project(x, w["wv"])
    if positions is None:
        positions = (torch.arange(S, device=x.device) if pos is None
                     else torch.full((S,), int(pos), device=x.device))
        positions = positions.expand(B, S)
    q = apply_rope(q, positions, cfg.rope_theta)
    kx = apply_rope(kx, positions, cfg.rope_theta)

    if cache is None:
        out = ops.flash_attention(q, kx, vx, causal=True, window=window,
                                  attn_softcap=cfg.attn_softcap)
        new_cache = AttnCache(kx, vx)
    else:
        p = int(pos)
        cache.k[:, p:p + S] = kx
        cache.v[:, p:p + S] = vx
        out = decode_attention(q, cache.k, cache.v, p, window=window,
                               attn_softcap=cfg.attn_softcap)
        new_cache = cache
    Hq, hd, d = w["wo"].shape
    out = out.reshape(B, S, Hq * hd) @ w["wo"].reshape(Hq * hd, d)
    return out, new_cache
