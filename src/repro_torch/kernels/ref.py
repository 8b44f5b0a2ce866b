"""Plain PyTorch versions of the port's kernels.

``attention_reference`` — naive full-softmax attention (quadratic memory),
a port of ``repro.kernels.ref.attention_reference``, equal to it on every
row.

``flash_attention_plain`` — the plain version of the CUDA flash-attention
kernel K1: the CPU path of ``ops.flash_attention`` and what the kernel is
held against on the card.  It is ``attention_reference`` on every row that
sees a key.

``flash_attention_lse_plain`` and ``flash_attention_bwd_plain`` — the
forward with its log-sum-exp and the backward of the reference's
``blockwise_attention`` (``_flash_fwd`` and ``_flash_bwd`` in
``repro.models.attention``), written densely rather than blockwise.  They
are the plain versions of the CUDA kernels K1 (with ``with_lse``) and K1b:
the CPU path of ``ops.blockwise_attention`` and what those kernels are held
against on the card.

A row that sees no key at all (possible only with Sq > Skv and a window)
has no answer the reference agrees on: ``attention_reference`` gives it the
mean of v, the blockwise version a mean that depends on its block size, and
the reference's VJP p = 1 on every masked entry.  The three plain versions
of the kernels give it FlashAttention's answer, as the kernels do: o = 0,
lse = NEG_INF, and no gradient (p = 0 and ds = 0 on all its entries).

``ssd_sequential``, ``ssd_chunk_terms`` and ``ssd_reference`` — the Mamba2
SSD scan step by step, the intra-chunk terms of one chunk batch, and the
chunked scan, ports of the reference's functions of the same names.  The
reference's ``lax.scan`` over time or chunks is a Python loop here.
``ssd_chunk_terms`` is what the CUDA SSD chunk kernel K2 computes;
``ssd_chunk_plain`` applies it to all chunks at once (K2's plain version),
and ``ssd_chunk_bwd_plain`` is its VJP (the plain version of K2b, the SSD
backward kernel).  Unlike the reference, ``ssd_chunk_terms`` masks the
pairwise log-decay before its exp, so its gradients stay finite where a
chunk's decay passes ~88 and the unmasked exp is inf above the diagonal.
``ssd_pass_plain`` is the recurrence between chunks that follows the chunk
terms, a loop over chunks (the plain version of K3), and
``ssd_pass_bwd_plain`` its backward written out as a reverse scan (the
plain version of K3b).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30     # finite: a fully masked row must not turn into NaN


def _masked_scores(q, k, *, causal, window, attn_softcap, q_offset=0):
    """Scaled, capped, masked f32 scores (B, Sq, Hkv, G, Skv) from the
    inputs' values (the reference's preferred_element_type=f32) and the
    mask (Sq, Skv), as the reference's ``_block_scores``."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
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
    return torch.where(mask[None, :, None, None, :], s, NEG_INF), mask


def _softmax_attention(q, k, v, *, causal, window, attn_softcap, q_offset,
                       rows_without_key_zero):
    s, mask = _masked_scores(q, k, causal=causal, window=window,
                             attn_softcap=attn_softcap, q_offset=q_offset)
    p = torch.softmax(s, dim=-1)
    if rows_without_key_zero:
        # masked entries of a row with a key are already exactly 0
        p = torch.where(mask[None, :, None, None, :], p, 0.0)
    # p rounds to v's type before the product, as in the reference
    o = torch.einsum("bshgk,bkhd->bshgd", p.to(v.dtype), v)
    return o.reshape(q.shape).to(q.dtype)


def attention_reference(q, k, v, *, causal: bool = True, window: int = 0,
                        attn_softcap: float = 0.0, q_offset: int = 0):
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D)."""
    return _softmax_attention(q, k, v, causal=causal, window=window,
                              attn_softcap=attn_softcap, q_offset=q_offset,
                              rows_without_key_zero=False)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          attn_softcap: float = 0.0, q_offset: int = 0):
    """The plain version of K1: ``attention_reference``, with 0 on a row
    that sees no key.  ``q_offset`` is the position of q[:, 0] (the
    sequence-parallel chunk's start), as in every function here."""
    return _softmax_attention(q, k, v, causal=causal, window=window,
                              attn_softcap=attn_softcap, q_offset=q_offset,
                              rows_without_key_zero=True)


def flash_attention_lse_plain(q, k, v, *, causal: bool = True, window: int = 0,
                              attn_softcap: float = 0.0, q_offset: int = 0):
    """The forward of ``blockwise_attention`` with its log-sum-exp.

    q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (o (B, Sq, Hq, D) in q's
    type, lse f32 (B, Sq, Hq)).  As ``_flash_fwd``: p = exp(s - m) in f32
    times v in f32, l clamped at 1e-30, lse = m + log(l) in natural log;
    p = 0 on masked entries, so a row that sees no key gets o = 0 and
    lse = NEG_INF.
    """
    B, Sq, Hq, D = q.shape
    s, mask = _masked_scores(q, k, causal=causal, window=window,
                             attn_softcap=attn_softcap, q_offset=q_offset)
    m = s.amax(dim=-1)
    p = torch.where(mask[None, :, None, None, :], torch.exp(s - m[..., None]),
                    0.0)
    l = p.sum(dim=-1).clamp_min(1e-30)
    acc = torch.einsum("bshgk,bkhd->bshgd", p, v.float())
    o = (acc / l[..., None]).to(q.dtype).reshape(B, Sq, Hq, D)
    return o, (m + torch.log(l)).reshape(B, Sq, Hq)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: int = 0, attn_softcap: float = 0.0,
                              q_offset: int = 0):
    """Gradients (dq, dk, dv) of attention from the forward's o and lse.

    The formulas of ``_flash_bwd``: delta = rowsum(o * do) in f32;
    p = exp(s - lse), 0 on masked entries (the reference's is 1 on those of
    a row that sees no key); dv = p^T do; dp = do v^T; ds = p (dp - delta), times
    1 - (s/cap)^2 under a soft cap; masked entries of ds set to 0, then ds
    scaled by D^-0.5; dq = ds k, dk = ds^T q, all in f32 and cast to the
    inputs' types.
    """
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    s, mask = _masked_scores(q, k, causal=causal, window=window,
                             attn_softcap=attn_softcap, q_offset=q_offset)
    dog = do.float().reshape(B, Sq, Hkv, G, D)
    delta = (o.float() * do.float()).reshape(B, Sq, Hkv, G, D).sum(-1)
    p = torch.where(mask[None, :, None, None, :],
                    torch.exp(s - lse.reshape(B, Sq, Hkv, G)[..., None]), 0.0)
    dv = torch.einsum("bshgk,bshgd->bkhd", p, dog)
    dp = torch.einsum("bshgd,bkhd->bshgk", dog, v.float())
    ds = p * (dp - delta[..., None])
    if attn_softcap:
        ds = ds * (1.0 - torch.square(s / attn_softcap))
    ds = torch.where(mask[None, :, None, None, :], ds, 0.0) * (D ** -0.5)
    dq = torch.einsum("bshgk,bkhd->bshgd", ds, k.float())
    dk = torch.einsum("bshgk,bshgd->bkhd", ds,
                      q.float().reshape(B, Sq, Hkv, G, D))
    return (dq.reshape(B, Sq, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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
    # pairwise decay exp(L_i - L_j) for j <= i.  Above the diagonal diff is
    # large and positive and its exp may be inf: a product with the mask
    # would give NaN, and a select after the exp alone would still send
    # 0 * inf = NaN into the gradient.  So diff is selected to 0 there
    # before the exp and the exp selected to 0 after it; the values are
    # those of a single select after the exp.
    diff = (Li[:, :, :, None] - Li[:, :, None, :]).to(dtype)   # (B,H,Qi,Qj)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    L = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
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


def ssd_chunks(x, chunk):
    """(Q, nc): the chunk length min(chunk, S) and the number of chunks."""
    S = x.shape[1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd_chunk: seq {S} not divisible by chunk {Q}")
    return Q, S // Q


def ssd_chunk_plain(x, dt, A, B_, C_, *, chunk: int):
    """All chunks' intra-chunk terms at once, through ``ssd_chunk_terms``.

    x: (B,S,H,P); dt: (B,S,H); A: (H,); B_/C_: (B,S,N), each upcast to f32.
    Returns y_intra (B,S,H,P), states (B,H,nc,P,N), decay_all (B,H,nc,Q),
    decay_chunk (B,H,nc), all f32.
    """
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    Q, nc = ssd_chunks(x, chunk)
    y, st, dall, dch = ssd_chunk_terms(
        x.float().reshape(Bsz * nc, Q, H, P), dt.float().reshape(Bsz * nc, Q, H),
        A.float(), B_.float().reshape(Bsz * nc, Q, N),
        C_.float().reshape(Bsz * nc, Q, N))
    return (y.reshape(Bsz, S, H, P),
            st.reshape(Bsz, nc, H, P, N).transpose(1, 2),
            dall.reshape(Bsz, nc, H, Q).transpose(1, 2),
            dch.reshape(Bsz, nc, H).transpose(1, 2))


def ssd_chunk_bwd_plain(x, dt, A, B_, C_, dy, dstates, ddall, ddchunk, *,
                        chunk: int):
    """The VJP of :func:`ssd_chunk_plain`: autograd through the masked
    ``ssd_chunk_terms`` on the inputs upcast to f32.

    dy (B,S,H,P), dstates (B,H,nc,P,N), ddall (B,H,nc,Q), ddchunk (B,H,nc):
    the cotangents of the four terms.  Returns (dx, ddt, dA, dB, dC) in the
    shapes of x, dt, A, B_, C_: dx summed in f32 and rounded once to x's
    type, the rest f32.
    """
    with torch.enable_grad():
        ins = [t.detach().float().requires_grad_() for t in (x, dt, A, B_, C_)]
        outs = ssd_chunk_plain(*ins, chunk=chunk)
        dx, *rest = torch.autograd.grad(
            outs, ins, [g.float() for g in (dy, dstates, ddall, ddchunk)])
    return (dx.to(x.dtype), *rest)


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

    Cc: (B,Q,N) f32; decay_all: (B,H,Q); h: (B,H,P,N) -> (B,Q,H,P).  The
    plain route's (``ssd_reference``, ``ssd_pass_plain``); the CUDA route
    forms it inside K3."""
    return (torch.einsum("bqn,bhpn->bqhp", Cc, h)
            * decay_all.transpose(1, 2)[..., None])


def _wide(t):
    """``t`` in f32, or f64 where it is f64 (the plain versions' tests run
    the recurrence in f64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def ssd_pass_plain(y_intra, states, decay_all, decay_chunk, C_, h0=None, *,
                   dtype):
    """The recurrence between chunks, a loop over chunks: the plain version
    of K3 (``ssd_pass_kernel``).

    y_intra (B,S,H,P), states (B,H,nc,P,N), decay_all (B,H,nc,Q),
    decay_chunk (B,H,nc): ``ssd_chunk_plain``'s terms; C_ (B,S,N); h0
    (B,H,P,N) the state before the first chunk, zeros if None.  With
    h_prev[c] = h_{c-1} (h_{-1} = h0) and h_c = h_{c-1} decay_chunk_c +
    states_c, returns (y = y_intra + decay_all C_c h_prev[c]^T in
    ``dtype``, hT = h_{nc-1}, h_prev (B,H,nc,P,N)), the last two f32.
    """
    Bsz, S, H, P = y_intra.shape
    nc, N = states.shape[2], states.shape[-1]
    Cr = _wide(C_).reshape(Bsz, nc, S // nc, N)
    h = (torch.zeros((Bsz, H, P, N), dtype=states.dtype, device=states.device)
         if h0 is None else _wide(h0))
    y_inter, h_prev = [], []
    for c in range(nc):
        h_prev.append(h)
        y_inter.append(inter_chunk_y(Cr[:, c], decay_all[:, :, c], h))
        h = h * decay_chunk[:, :, c, None, None] + states[:, :, c]
    y_inter = torch.stack(y_inter, dim=1).view(Bsz, S, H, P)
    return (y_intra + y_inter).to(dtype), h, torch.stack(h_prev, dim=2)


def ssd_pass_bwd_plain(dy, dhT, h_prev, decay_all, decay_chunk, C_):
    """The VJP of :func:`ssd_pass_plain` written out: the plain version of
    K3b (``ssd_pass_bwd_kernel``), the same algorithm.

    dy (B,S,H,P) and dhT (B,H,P,N, zeros if None) the cotangents of y and
    hT; h_prev the forward's.  With g_c = dy_c decay_all_c: d y_intra = dy,
    d decay_all_c[q] = sum_p dy[q,p] (C_c h_prev[c]^T)[q,p], dC_c = sum_h
    g_c h_prev[c], X_c = g_c^T C_c; then a reverse scan whose carry starts
    at dhT: for c from nc-1 down to 0, d states_c = carry, d decay_chunk_c
    = sum carry h_prev[c], carry <- carry decay_chunk_c + X_c.  Returns
    (d y_intra, d states, d decay_all, d decay_chunk, dC, dh0 = the last
    carry), all f32 (f64 for f64 inputs).
    """
    Bsz, S, H, P = dy.shape
    nc, N = h_prev.shape[2], h_prev.shape[-1]
    dyc = _wide(dy).reshape(Bsz, nc, S // nc, H, P)
    Cr = _wide(C_).reshape(Bsz, nc, S // nc, N)
    z = torch.einsum("bcqn,bhcpn->bhcqp", Cr, h_prev)
    ddall = torch.einsum("bcqhp,bhcqp->bhcq", dyc, z)
    g = dyc * decay_all.permute(0, 2, 3, 1)[..., None]
    dC = torch.einsum("bcqhp,bhcpn->bcqn", g, h_prev).reshape(Bsz, S, N)
    dstates = torch.einsum("bcqhp,bcqn->bhcpn", g, Cr)    # X, then d states
    ddchunk = torch.empty_like(decay_chunk)
    carry = torch.zeros_like(dstates[:, :, 0]) if dhT is None else _wide(dhT)
    for c in reversed(range(nc)):
        x = dstates[:, :, c].clone()
        dstates[:, :, c] = carry
        ddchunk[:, :, c] = (carry * h_prev[:, :, c]).sum((-2, -1))
        carry = carry * decay_chunk[:, :, c, None, None] + x
    return (dyc.reshape(Bsz, S, H, P), dstates, ddall, ddchunk, dC, carry)
