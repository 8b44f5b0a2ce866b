"""Public wrappers for the port's kernels.

A CUDA tensor goes to the CUDA kernel, with no fallback: the kernel runs or
the call raises.  A CPU tensor goes to the kernel's plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention_fwd, flash_attention_plain
from .ref import inter_chunk_y
from .ssd import ssd_chunk_kernel, ssd_chunk_plain


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


def ssd_chunk(x, dt, A, B_, C_, *, chunk: int):
    """Intra-chunk SSD terms (y_intra, states, decay_all, decay_chunk)."""
    if x.device.type == "cuda":
        return ssd_chunk_kernel(x, dt, A, B_, C_, chunk=chunk)
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dt, A, B_, C_, chunk=chunk)
    raise ValueError(f"ssd_chunk: unsupported device {x.device}")


def ssd(x, dt, A, B_, C_, chunk: int = 128, interpret: Optional[bool] = None,
        *, h0: Optional[torch.Tensor] = None):
    """SSD scan, forward only: the intra-chunk terms (:func:`ssd_chunk`)
    and the recurrence between chunks, a loop over chunks.

    x: (B,S,H,P); dt: (B,S,H) f32; A: (H,) f32; B_/C_: (B,S,N); h0: the
    state before the first chunk, (B,H,P,N), zeros if None (the contract of
    ``ssd_reference``).  ``interpret`` keeps the reference's signature and
    changes nothing.  Returns (y (B,S,H,P) in x's type, final state
    (B,H,P,N) f32).
    """
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    y_intra, states, dall, dchunk = ssd_chunk(x, dt, A, B_, C_, chunk=Q)
    nc = S // Q
    Cr = C_.float().reshape(Bsz, nc, Q, N)
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    y_inter = torch.empty((Bsz, nc, Q, H, P), dtype=torch.float32,
                          device=x.device)
    for c in range(nc):
        y_inter[:, c] = inter_chunk_y(Cr[:, c], dall[:, :, c], h)
        h = h * dchunk[:, :, c, None, None] + states[:, :, c]
    return (y_intra + y_inter.view(Bsz, S, H, P)).to(x.dtype), h
