"""Public wrappers for the port's kernels.

A CUDA tensor goes to the CUDA kernel, with no fallback: the kernel runs or
the call raises.  A CPU tensor goes to the kernel's plain version.
"""
from __future__ import annotations

from typing import Optional

from .flash_attention import flash_attention_fwd, flash_attention_plain


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    attn_softcap: float = 0.0, block_q: int = 128,
                    block_k: int = 128, interpret: Optional[bool] = None):
    """Forward-only flash attention (the prefill hot path).

    q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D).  ``block_q``, ``block_k`` and
    ``interpret`` keep the reference's signature; the CUDA kernel has its
    own tiles and is never interpreted, so they change nothing.
    """
    if q.device.type == "cuda":
        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   attn_softcap=attn_softcap)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     attn_softcap=attn_softcap)
    raise ValueError(f"flash_attention: unsupported device {q.device}")
