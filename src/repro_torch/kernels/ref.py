"""Plain PyTorch versions of the port's kernels.

``attention_reference`` — naive full-softmax attention (quadratic memory),
a port of ``repro.kernels.ref.attention_reference``.  It is the plain
version of the CUDA flash-attention kernel: the CPU path of
``ops.flash_attention`` and what the kernel is held against on the card.

``ssd_sequential``, ``ssd_chunk_terms`` and ``ssd_reference`` — the Mamba2
SSD scan step by step, the intra-chunk terms of one chunk batch, and the
chunked scan, ports of the reference's functions of the same names.  The
reference's ``lax.scan`` over time or chunks is a Python loop here.
``ssd_chunk_terms`` is what the CUDA SSD chunk kernel computes
(``ssd.ssd_chunk_plain`` applies it to all chunks at once).
"""
from __future__ import annotations

from typing import Optional

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


# ------------------------------- SSD ----------------------------------- #

def ssd_sequential(x, dt, A, B_, C_, h0: Optional[torch.Tensor] = None):
    """Step-by-step SSM recurrence (slow oracle).

    x: (B,S,H,P); dt: (B,S,H); A: (H,); B_/C_: (B,S,N).
    h_t = exp(dt_t A) h_{t-1} + dt_t * x_t (outer) B_t ;  y_t = C_t . h_t
    Returns (y (B,S,H,P) in x's type, final state (B,H,P,N) f32).
    """
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    xf, dtf = x.float(), dt.float()
    Bf, Cf = B_.float(), C_.float()
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        dtt = dtf[:, t]                                   # (B,H)
        decay = torch.exp(dtt * A[None, :])
        dbx = torch.einsum("bh,bhp,bn->bhpn", dtt, xf[:, t], Bf[:, t])
        h = h * decay[..., None, None] + dbx
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_chunk_terms(xc, dtc, A, Bc, Cc):
    """Intra-chunk SSD terms for one chunk batch.

    xc: (B,Q,H,P); dtc: (B,Q,H); A: (H,); Bc/Cc: (B,Q,N).
    Returns (y_intra (B,Q,H,P), state (B,H,P,N), decay_all (B,H,Q),
    decay_chunk (B,H)), in the inputs' type (f32 from every caller).

    The log-decay L is summed, and differenced, in float64, as the CUDA
    kernel does; the reference sums it in the inputs' type.  |L| reaches
    ~1000 across a 256-long chunk at the model's decays, where an f32 L
    carries ~1e-4 of absolute error into every exp(L_i - L_j)
    (tools/ssd_conditioning.py); at the reference's test sizes the two
    agree to 1e-5 (tests/test_torch_ssd.py).
    """
    Q, dtype = xc.shape[1], xc.dtype
    la = dtc * A[None, None, :]                       # (B,Q,H) log-decay
    Li = torch.cumsum(la.double(), dim=1).transpose(1, 2)   # L_i (B,H,Q)
    # pairwise decay exp(L_i - L_j) for j <= i.  A select, not a product
    # with the mask: above the diagonal diff is large and positive, exp of
    # it is inf, and inf * 0 would be NaN.
    diff = (Li[:, :, :, None] - Li[:, :, None, :]).to(dtype)   # (B,H,Qi,Qj)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    L = torch.where(mask, torch.exp(diff), 0.0)
    cb = torch.einsum("bin,bjn->bij", Cc, Bc)         # (B,Qi,Qj)
    M = cb[:, None] * L * dtc.transpose(1, 2)[:, :, None, :]   # (B,H,Qi,Qj)
    y_intra = torch.einsum("bhij,bjhp->bihp", M, xc)
    # chunk state: sum_j exp(L_Q - L_j) dt_j B_j (outer) x_j
    decay_to_end = torch.exp((Li[:, :, -1:] - Li).to(dtype))   # (B,H,Q)
    w = (decay_to_end * dtc.transpose(1, 2)).transpose(1, 2)   # (B,Q,H)
    state = torch.einsum("bqhp,bqn->bhpn", xc * w[..., None], Bc)
    decay_all = torch.exp(Li.to(dtype))               # exp(L_i) (B,H,Q)
    decay_chunk = torch.exp(Li[:, :, -1].to(dtype))   # (B,H)
    return y_intra, state, decay_all, decay_chunk


def ssd_reference(x, dt, A, B_, C_, *, chunk: int, h0=None):
    """Chunked SSD: a loop over chunks of length ``chunk``.

    Same contract as :func:`ssd_sequential` but O(S*Q) memory / step.
    """
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    nc = S // Q
    xf = x.float().reshape(Bsz, nc, Q, H, P)
    dtf = dt.float().reshape(Bsz, nc, Q, H)
    Bf = B_.float().reshape(Bsz, nc, Q, N)
    Cf = C_.float().reshape(Bsz, nc, Q, N)
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for c in range(nc):
        y_intra, state, decay_all, decay_chunk = ssd_chunk_terms(
            xf[:, c], dtf[:, c], A, Bf[:, c], Cf[:, c])
        # inter-chunk: y_i += C_i . (exp(L_i) * h_prev)
        y_inter = inter_chunk_y(Cf[:, c], decay_all, h)
        h = h * decay_chunk[..., None, None] + state
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bsz, S, H, P)
    return y.to(x.dtype), h


def inter_chunk_y(Cc, decay_all, h):
    """The history's share of a chunk's output: C_i . (exp(L_i) h_prev).

    Cc: (B,Q,N) f32; decay_all: (B,H,Q); h: (B,H,P,N) -> (B,Q,H,P)."""
    return (torch.einsum("bqn,bhpn->bqhp", Cc, h)
            * decay_all.transpose(1, 2)[..., None])
