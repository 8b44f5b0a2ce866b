"""Public wrappers for the port's kernels.

A CUDA tensor goes to the CUDA kernel, with no fallback: the kernel runs or
the call raises.  A CPU tensor goes to the kernel's plain version.  A
``meta`` tensor (the dry-run's, shape and dtype without storage) gets empty
outputs of the kernel's shapes and dtypes.  On every route a running step
counter (``repro_torch.roofline.counter``) adds the kernel's cost from
``kernels.cost`` and none of the route's own ops.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import cost as _cost
from .flash_attention import (flash_attention_bwd, flash_attention_bwd_plain,
                              flash_attention_fwd, flash_attention_lse_plain,
                              flash_attention_plain)
from .ref import ssd_pass_bwd_plain, ssd_pass_plain
from .ssd import (ssd_chunk_bwd_kernel, ssd_chunk_bwd_plain, ssd_chunk_kernel,
                  ssd_chunk_plain, ssd_chunks)
from .ssd_pass import ssd_pass_bwd_kernel, ssd_pass_kernel


def _dense(outs):
    """The plain version's outputs laid out as the kernel writes them
    (contiguous), so that what follows a call runs the same ops on every
    route."""
    if isinstance(outs, tuple):
        return tuple(None if t is None else t.contiguous() for t in outs)
    return outs.contiguous()


def _meta_like(t, shape=None, dtype=None):
    return torch.empty(t.shape if shape is None else shape,
                       dtype=t.dtype if dtype is None else dtype,
                       device="meta")


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
    with _cost.counted("flash_attention_fwd", lambda: _cost.flash_fwd_cost(
            q, k, causal=causal, window=window,
            q_offset=kw["q_offset"])) as track:
        if q.device.type == "cuda":
            return track(flash_attention_fwd(q, k, v, **kw))
        if q.device.type == "cpu":
            return track(_dense(flash_attention_plain(q, k, v, **kw)))
        if q.device.type == "meta":
            return track(_meta_like(q))
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def flash_attention_lse(q, k, v, *, causal: bool, window: int,
                        attn_softcap: float, q_offset: int = 0):
    """Flash attention forward with its lse: (o, lse f32 (B, Sq, Hq))."""
    kw = dict(causal=causal, window=window, attn_softcap=attn_softcap,
              q_offset=q_offset)
    with _cost.counted("flash_attention_fwd", lambda: _cost.flash_fwd_cost(
            q, k, causal=causal, window=window, q_offset=q_offset,
            with_lse=True)) as track:
        if q.device.type == "cuda":
            return track(flash_attention_fwd(q, k, v, with_lse=True, **kw))
        if q.device.type == "cpu":
            return track(_dense(flash_attention_lse_plain(q, k, v, **kw)))
        if q.device.type == "meta":
            return track((_meta_like(q),
                          _meta_like(q, q.shape[:3], torch.float32)))
    raise ValueError(f"flash_attention_lse: unsupported device {q.device}")


def flash_attention_grads(q, k, v, o, lse, do, *, causal: bool, window: int,
                          attn_softcap: float, q_offset: int = 0):
    """Flash attention backward: (dq, dk, dv)."""
    kw = dict(causal=causal, window=window, attn_softcap=attn_softcap,
              q_offset=q_offset)
    with _cost.counted("flash_attention_bwd", lambda: _cost.flash_bwd_cost(
            q, k, causal=causal, window=window, q_offset=q_offset)) as track:
        if q.device.type == "cuda":
            return track(flash_attention_bwd(q, k, v, o, lse, do, **kw))
        if q.device.type == "cpu":
            return track(_dense(flash_attention_bwd_plain(q, k, v, o, lse,
                                                          do, **kw)))
        if q.device.type == "meta":
            return track(tuple(_meta_like(t) for t in (q, k, v)))
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
    with _cost.counted("ssd_chunk_kernel", lambda: _cost.ssd_chunk_cost(
            x, B_, chunk=chunk)) as track:
        if x.device.type == "cuda":
            return track(ssd_chunk_kernel(x, dt, A, B_, C_, chunk=chunk))
        if x.device.type == "cpu":
            return track(_dense(ssd_chunk_plain(x, dt, A, B_, C_,
                                                chunk=chunk)))
        if x.device.type == "meta":
            Bsz, S, H, P = x.shape
            Q, nc = ssd_chunks(x, chunk)
            f32 = torch.float32
            return track((_meta_like(x, None, f32),
                          _meta_like(x, (Bsz, H, nc, P, B_.shape[-1]), f32),
                          _meta_like(x, (Bsz, H, nc, Q), f32),
                          _meta_like(x, (Bsz, H, nc), f32)))
    raise ValueError(f"ssd_chunk: unsupported device {x.device}")


def ssd_chunk_grads(x, dt, A, B_, C_, dy, dstates, ddall, ddchunk, *,
                    chunk: int):
    """The VJP of :func:`ssd_chunk`: (dx in x's type, ddt, dA, dB, dC
    f32)."""
    with _cost.counted("ssd_chunk_bwd_kernel",
                       lambda: _cost.ssd_chunk_bwd_cost(x, B_, chunk=chunk)
                       ) as track:
        if x.device.type == "cuda":
            return track(ssd_chunk_bwd_kernel(x, dt, A, B_, C_, dy, dstates,
                                              ddall, ddchunk, chunk=chunk))
        if x.device.type == "cpu":
            return track(_dense(ssd_chunk_bwd_plain(
                x, dt, A, B_, C_, dy, dstates, ddall, ddchunk, chunk=chunk)))
        if x.device.type == "meta":
            f32 = torch.float32
            return track((_meta_like(x), _meta_like(dt, None, f32),
                          _meta_like(A, None, f32), _meta_like(B_, None, f32),
                          _meta_like(C_, None, f32)))
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


def ssd_pass(y_intra, states, decay_all, decay_chunk, C_, h0=None, *,
             dtype):
    """The recurrence between chunks (K3): (y in ``dtype``, hT, h_prev
    (B,H,nc,P,N) f32), the contract of ``ref.ssd_pass_plain``."""
    with _cost.counted("ssd_pass_kernel", lambda: _cost.ssd_pass_cost(
            y_intra, states, C_, with_h0=h0 is not None)) as track:
        if C_.device.type == "cuda":
            # K2 writes its terms dense; a plain ``ssd_chunk`` swapped in
            # on the card (a route check) hands views
            y_intra, states, decay_all, decay_chunk = _dense(
                (y_intra, states, decay_all, decay_chunk))
            return track(ssd_pass_kernel(
                y_intra, states, decay_all, decay_chunk, C_,
                None if h0 is None else h0.contiguous(), dtype=dtype))
        if C_.device.type == "cpu":
            return track(_dense(ssd_pass_plain(
                y_intra, states, decay_all, decay_chunk, C_, h0,
                dtype=dtype)))
        if C_.device.type == "meta":
            Bsz, _, H, P = y_intra.shape
            return track((_meta_like(y_intra, None, dtype),
                          _meta_like(states, (Bsz, H, P, states.shape[-1])),
                          _meta_like(states)))
    raise ValueError(f"ssd_pass: unsupported device {C_.device}")


def ssd_pass_grads(dy, dhT, h_prev, decay_all, decay_chunk, C_, *,
                   with_dh0: bool):
    """The VJP of :func:`ssd_pass` (K3b): (d y_intra, d states, d
    decay_all, d decay_chunk, dC, dh0 or None), all f32."""
    with _cost.counted("ssd_pass_bwd_kernel", lambda: _cost.ssd_pass_bwd_cost(
            dy, h_prev, C_, with_dhT=dhT is not None, with_dh0=with_dh0)
            ) as track:
        if C_.device.type == "cuda":
            return track(ssd_pass_bwd_kernel(dy, dhT, h_prev, decay_all,
                                             decay_chunk, C_,
                                             with_dh0=with_dh0))
        if C_.device.type == "cpu":
            *grads, dh0 = ssd_pass_bwd_plain(dy, dhT, h_prev, decay_all,
                                             decay_chunk, C_)
            return track(_dense((*grads, dh0 if with_dh0 else None)))
        if C_.device.type == "meta":
            f32 = torch.float32
            return track((_meta_like(dy, None, f32), _meta_like(h_prev),
                          _meta_like(decay_all), _meta_like(decay_chunk),
                          _meta_like(C_, None, f32),
                          _meta_like(h_prev, h_prev[:, :, 0].shape)
                          if with_dh0 else None))
    raise ValueError(f"ssd_pass_grads: unsupported device {C_.device}")


class _SSDPass(torch.autograd.Function):
    """The recurrence between chunks with its backward: the forward saves
    the state entering each chunk (h_prev) with decay_all, decay_chunk and
    C_, and the backward runs the reverse scan.  Both directions look up
    ``ssd_pass`` and ``ssd_pass_grads`` in this module when they run."""

    @staticmethod
    def forward(ctx, y_intra, states, decay_all, decay_chunk, C_, h0, dtype):
        ctx.set_materialize_grads(False)
        y, hT, h_prev = ssd_pass(y_intra, states, decay_all, decay_chunk, C_,
                                 h0, dtype=dtype)
        ctx.save_for_backward(h_prev, decay_all, decay_chunk, C_)
        ctx.y_spec = (y.shape, y.dtype)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        h_prev, decay_all, decay_chunk, C_ = ctx.saved_tensors
        if dy is None:          # only hT reaches the loss
            shape, dtype = ctx.y_spec
            dy = torch.zeros(shape, dtype=dtype, device=h_prev.device)
        grads = ssd_pass_grads(dy.contiguous(),
                               None if dhT is None else dhT.contiguous(),
                               h_prev, decay_all,
                               decay_chunk, C_,
                               with_dh0=ctx.needs_input_grad[5])
        # dC comes in f32; autograd rounds it to C_'s type
        return (*grads, None)


def ssd(x, dt, A, B_, C_, chunk: int = 128, interpret: Optional[bool] = None,
        *, h0: Optional[torch.Tensor] = None):
    """SSD scan: the intra-chunk terms (:func:`ssd_chunk`) and the
    recurrence between chunks (:func:`ssd_pass`).

    x: (B,S,H,P); dt: (B,S,H) f32; A: (H,) f32; B_/C_: (B,S,N); h0: the
    state before the first chunk, (B,H,P,N), zeros if None (the contract of
    ``ssd_reference``).  ``interpret`` keeps the reference's signature and
    changes nothing.  Returns (y (B,S,H,P) in x's type, final state
    (B,H,P,N) f32).

    Differentiable: the chunk terms go through ``_SSDChunk`` (K2 forward,
    K2b backward on CUDA tensors) and the recurrence through ``_SSDPass``
    (K3 forward, K3b backward), ``h0`` included; with no input requiring
    grad, just the forwards.
    """
    Q = min(chunk, x.shape[1])
    y_intra, states, dall, dchunk = _SSDChunk.apply(x, dt, A, B_, C_, Q)
    return _SSDPass.apply(y_intra, states, dall, dchunk, C_,
                          None if h0 is None else h0.float(), x.dtype)
