"""Public wrappers for the port's kernels.

A CUDA tensor goes to the CUDA kernel, with no fallback: the kernel runs or
the call raises.  A CPU tensor goes to the kernel's plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import (flash_attention_bwd, flash_attention_bwd_plain,
                              flash_attention_fwd, flash_attention_lse_plain,
                              flash_attention_plain)
from .ref import inter_chunk_y
from .ssd import (ssd_chunk_bwd_kernel, ssd_chunk_bwd_plain, ssd_chunk_kernel,
                  ssd_chunk_plain)


def _offset(q_offset):
    """q_offset as an int: the position of q[:, 0], never negative."""
    off = int(q_offset)
    if off < 0:
        raise ValueError(f"q_offset must be >= 0, got {off}")
    return off


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    attn_softcap: float = 0.0, block_q: int = 128,
                    block_k: int = 128, interpret: Optional[bool] = None,
                    q_offset: int = 0):
    """Forward-only flash attention (the prefill hot path).

    q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D); q row i at position
    ``q_offset + i``.  ``block_q``, ``block_k`` and ``interpret`` keep the
    reference's signature; the CUDA kernel has its own tiles and is never
    interpreted, so they change nothing.
    """
    kw = dict(causal=causal, window=window, attn_softcap=attn_softcap,
              q_offset=_offset(q_offset))
    if q.device.type == "cuda":
        return flash_attention_fwd(q, k, v, **kw)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, **kw)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def flash_attention_lse(q, k, v, *, causal: bool, window: int,
                        attn_softcap: float, q_offset: int = 0):
    """Flash attention forward with its lse: (o, lse f32 (B, Sq, Hq))."""
    kw = dict(causal=causal, window=window, attn_softcap=attn_softcap,
              q_offset=q_offset)
    if q.device.type == "cuda":
        return flash_attention_fwd(q, k, v, with_lse=True, **kw)
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v, **kw)
    raise ValueError(f"flash_attention_lse: unsupported device {q.device}")


def flash_attention_grads(q, k, v, o, lse, do, *, causal: bool, window: int,
                          attn_softcap: float, q_offset: int = 0):
    """Flash attention backward: (dq, dk, dv)."""
    kw = dict(causal=causal, window=window, attn_softcap=attn_softcap,
              q_offset=q_offset)
    if q.device.type == "cuda":
        return flash_attention_bwd(q, k, v, o, lse, do, **kw)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    raise ValueError(f"flash_attention_grads: unsupported device {q.device}")


class _BlockwiseAttention(torch.autograd.Function):
    """Attention whose forward saves only (q, k, v, o, lse) and whose
    backward recomputes the scores: the reference's custom VJP.  Both
    directions look up ``flash_attention_lse`` and ``flash_attention_grads``
    in this module when they run."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, causal, window, attn_softcap):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        ctx.opts = dict(causal=causal, window=window,
                        attn_softcap=attn_softcap, q_offset=q_offset)
        o, lse = flash_attention_lse(q, k, v, **ctx.opts)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_grads(q, k, v, o, lse, do.contiguous(),
                                           **ctx.opts)
        return dq, dk, dv, None, None, None, None


def blockwise_attention(q, k, v, q_offset=0, causal: bool = True,
                        window: int = 0, attn_softcap: float = 0.0,
                        block_k: int = 512, block_q: int = 512):
    """Differentiable flash attention, the training path: q (B,Sq,Hq,D) x
    k/v (B,Skv,Hkv,D) -> (B,Sq,Hq,D).

    The reference's signature (``repro.models.attention.blockwise_attention``).
    On CUDA tensors the forward is the flash kernel K1 writing its lse and
    the backward the kernel K1b; on CPU tensors their plain versions.
    ``block_k`` and ``block_q`` change nothing: the kernels have their own
    tiles.  ``q_offset`` is the position of q[:, 0]: nonzero under
    sequence-parallel attention, where each model rank holds a contiguous
    chunk of q against the whole of k and v
    (``models.attention.sharded_flash_attention``).  dk and dv are summed
    over the rows this call holds; the sum across chunks is the caller's.
    """
    return _BlockwiseAttention.apply(q, k, v, _offset(q_offset), bool(causal),
                                     int(window), float(attn_softcap))


def ssd_chunk(x, dt, A, B_, C_, *, chunk: int):
    """Intra-chunk SSD terms (y_intra, states, decay_all, decay_chunk)."""
    if x.device.type == "cuda":
        return ssd_chunk_kernel(x, dt, A, B_, C_, chunk=chunk)
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dt, A, B_, C_, chunk=chunk)
    raise ValueError(f"ssd_chunk: unsupported device {x.device}")


def ssd_chunk_grads(x, dt, A, B_, C_, dy, dstates, ddall, ddchunk, *,
                    chunk: int):
    """The VJP of :func:`ssd_chunk`: (dx in x's type, ddt, dA, dB, dC
    f32)."""
    if x.device.type == "cuda":
        return ssd_chunk_bwd_kernel(x, dt, A, B_, C_, dy, dstates, ddall,
                                    ddchunk, chunk=chunk)
    if x.device.type == "cpu":
        return ssd_chunk_bwd_plain(x, dt, A, B_, C_, dy, dstates, ddall,
                                   ddchunk, chunk=chunk)
    raise ValueError(f"ssd_chunk_grads: unsupported device {x.device}")


class _SSDChunk(torch.autograd.Function):
    """The intra-chunk terms with their backward: the forward saves only
    (x, dt, A, B_, C_) and the backward recomputes the chunk terms, as the
    reference's custom VJP does.  Both directions look up ``ssd_chunk`` and
    ``ssd_chunk_grads`` in this module when they run."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C_, chunk):
        ctx.save_for_backward(x, dt, A, B_, C_)
        ctx.chunk = chunk
        return ssd_chunk(x, dt, A, B_, C_, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dstates, ddall, ddchunk):
        x, dt, A, B_, C_ = ctx.saved_tensors
        grads = ssd_chunk_grads(x, dt, A, B_, C_, dy.contiguous(),
                                dstates.contiguous(), ddall.contiguous(),
                                ddchunk.contiguous(), chunk=ctx.chunk)
        # dx comes in x's type; autograd rounds dB and dC (B,S,N) to the
        # type of B_ and C_
        return (*grads, None)


def ssd(x, dt, A, B_, C_, chunk: int = 128, interpret: Optional[bool] = None,
        *, h0: Optional[torch.Tensor] = None):
    """SSD scan: the intra-chunk terms (:func:`ssd_chunk`) and the
    recurrence between chunks, a loop over chunks.

    x: (B,S,H,P); dt: (B,S,H) f32; A: (H,) f32; B_/C_: (B,S,N); h0: the
    state before the first chunk, (B,H,P,N), zeros if None (the contract of
    ``ssd_reference``).  ``interpret`` keeps the reference's signature and
    changes nothing.  Returns (y (B,S,H,P) in x's type, final state
    (B,H,P,N) f32).

    Differentiable: the chunk terms go through ``_SSDChunk`` (K2 forward,
    K2b backward on CUDA tensors; with no input requiring grad, just the
    forward) and autograd differentiates the recurrence, ``h0`` included.
    """
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    y_intra, states, dall, dchunk = _SSDChunk.apply(x, dt, A, B_, C_, Q)
    nc = S // Q
    Cr = C_.float().reshape(Bsz, nc, Q, N)
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    y_inter = []
    for c in range(nc):
        y_inter.append(inter_chunk_y(Cr[:, c], dall[:, :, c], h))
        h = h * dchunk[:, :, c, None, None] + states[:, :, c]
    y_inter = torch.stack(y_inter, dim=1).view(Bsz, S, H, P)
    return (y_intra + y_inter).to(x.dtype), h
