"""K1b, flash attention backward: FLOPs and bytes of one call.

Five products over the pairs K1 computes (the kernel recomputes the
scores and issues seven; the bound counts five); q, k, v, o, do and the
f32 log-sum-exp read once, dq, dk and dv written once.
"""
from __future__ import annotations

from .flash_fwd import attention_pairs


def cost(b: int, sq: int, skv: int, hq: int, hkv: int, d: int, *,
         itemsize: int = 2, causal: bool = True, window: int = 0,
         q_offset: int = 0):
    """(FLOPs, bytes) of K1b for q (b, sq, hq, d), k and v (b, skv, hkv,
    d)."""
    pairs = attention_pairs(sq, skv, causal=causal, window=window,
                            q_offset=q_offset)
    q_bytes = b * sq * hq * d * itemsize
    k_bytes = b * skv * hkv * d * itemsize
    return (2 * 5 * d * pairs * b * hq,
            4 * q_bytes + 4 * k_bytes + 4 * b * sq * hq)
