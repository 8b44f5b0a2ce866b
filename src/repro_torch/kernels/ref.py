"""Plain PyTorch versions of the port's kernels.

``attention_reference`` — naive full-softmax attention (quadratic memory),
a port of ``repro.kernels.ref.attention_reference``.  It is the plain
version of the CUDA flash-attention kernel: the CPU path of
``ops.flash_attention`` and what the kernel is held against on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30     # finite: a fully masked row must not turn into NaN


def attention_reference(q, k, v, *, causal: bool = True, window: int = 0,
                        attn_softcap: float = 0.0, q_offset: int = 0):
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    # scores in f32 from the inputs' values (preferred_element_type=f32)
    s = torch.einsum("bshgd,bkhd->bshgk", qg.float(), k.float()) * (D ** -0.5)
    if attn_softcap:
        s = attn_softcap * torch.tanh(s / attn_softcap)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= kv_pos[None, :] > (q_pos[:, None] - window)
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # p rounds to v's type before the product, as in the reference
    o = torch.einsum("bshgk,bkhd->bshgd", p.to(v.dtype), v)
    return o.reshape(B, Sq, Hq, D).to(q.dtype)
