"""K1, flash attention forward: FLOPs and bytes of one call.

FLOPs count the two matrix products (q.k and p.v), 2 per multiply-add,
over the (q, kv) pairs that the causal mask, a window and ``q_offset``
leave; bytes count q, k and v read once and o written once (and the f32
log-sum-exp where the call writes it).
"""
from __future__ import annotations


def attention_pairs(sq: int, skv: int, *, causal: bool = True,
                    window: int = 0, q_offset: int = 0) -> int:
    """The (q row, kv column) pairs of one head: row i at position
    ``q_offset + i`` sees key j where j <= that position (causal) and
    j > position - window (a window)."""
    total = 0
    for i in range(sq):
        pos = q_offset + i
        hi = min(pos, skv - 1) if causal else skv - 1
        lo = max(pos - window + 1, 0) if window else 0
        total += max(hi - lo + 1, 0)
    return total


def cost(b: int, sq: int, skv: int, hq: int, hkv: int, d: int, *,
         itemsize: int = 2, causal: bool = True, window: int = 0,
         q_offset: int = 0, with_lse: bool = False):
    """(FLOPs, bytes) of K1 on q (b, sq, hq, d) against k, v (b, skv,
    hkv, d)."""
    pairs = attention_pairs(sq, skv, causal=causal, window=window,
                            q_offset=q_offset)
    q_bytes = b * sq * hq * d * itemsize
    k_bytes = b * skv * hkv * d * itemsize
    nbytes = 2 * q_bytes + 2 * k_bytes + (4 * b * sq * hq if with_lse else 0)
    return 4 * d * pairs * b * hq, nbytes
