"""GQA attention: flash attention through the kernels + KV-cache decode.

Port of ``repro.models.attention``.  The no-cache branch runs the flash
kernels on CUDA tensors and their plain versions on CPU tensors: with grad
enabled (training) through ``blockwise_attention``, the reference's
custom-VJP attention (forward K1 writing its lse, backward K1b); under
``torch.no_grad`` (the serving prefill) through the forward-only
``ops.flash_attention``.

Under a ``DeviceMesh`` (``sctx.mesh``) the activations are DTensors, and
``sharded_flash_attention`` and ``sharded_decode_attention`` take the place
of the reference's ``shard_map`` wrappers: each rank runs the same kernel
route on its local shard, inside ``local_map``.  Without a mesh the layer
runs exactly as it did before them.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..kernels import ops
from ..kernels.ops import blockwise_attention  # noqa: F401  (the reference's name)
from ..sharding.partition import (NULL_CTX, PartitionRules, local_region,
                                  mesh_shape, placements_for, spec_axes)
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


# ---------------------- sharded attention wrappers ---------------------- #

def _batch_entry(rules, B, mesh):
    """The spec entry the rules resolve for a batch of B on ``mesh``, and
    the size M of the model axis left to the heads (1 where the batch rule
    took it)."""
    bres = rules.spec_for(("batch",), (B,), mesh)
    bspec = bres[0] if bres else None
    M = (1 if "model" in spec_axes(bspec)
         else mesh_shape(mesh).get("model", 1))
    return bspec, M


def _attend(q, k, v, q_offset, window, attn_softcap):
    """One rank's body: the unsharded layer's kernel route, K1 and K1b
    through ``blockwise_attention`` with grad, the forward-only K1 without."""
    if torch.is_grad_enabled():
        return ops.blockwise_attention(q, k, v, q_offset, True, window,
                                       attn_softcap)
    return ops.flash_attention(q, k, v, causal=True, window=window,
                               attn_softcap=attn_softcap, q_offset=q_offset)


def attention_strategy(mesh, q_shape, Hkv, rules=None):
    """The reference's choice of tensor-parallel strategy, in its order:
    ``local`` (no model axis left), ``kv_heads`` (Hkv divides by M),
    ``q_heads`` (Hq divides by M and each shard of q heads maps to one kv
    head), ``seq`` (each model rank a contiguous q chunk), else ``local``.
    Returns (strategy, batch spec entry, M)."""
    B, S, Hq, _ = q_shape
    G = Hq // Hkv
    bspec, M = _batch_entry(rules or PartitionRules(), B, mesh)
    if M <= 1:
        strategy = "local"
    elif Hkv % M == 0:
        strategy = "kv_heads"
    elif Hq % M == 0 and G % (Hq // M) == 0:
        strategy = "q_heads"
    elif S % M == 0:
        strategy = "seq"
    else:
        strategy = "local"
    return strategy, bspec, M


def sharded_flash_attention(mesh, q, k, v, *, window: int = 0,
                            attn_softcap: float = 0.0, rules=None):
    """Flash attention on DTensors q (B,S,Hq,D), k/v (B,S,Hkv,D) over the
    ``DeviceMesh`` ``mesh``; the tensor-parallel strategy as the
    reference's (:func:`attention_strategy`), the batch over whatever the
    rules resolve for it.  Each rank runs :func:`_attend` on its shard:

    * ``kv_heads``: q, k, v sharded on their head dim over the model axis;
    * ``q_heads``: q's heads sharded, k and v replicated; a rank slices the
      one kv head its q heads use, and dk/dv come back through the slice's
      backward as partial sums over the model axis;
    * ``seq``: q's sequence sharded, each rank's chunk at
      ``q_offset = rank * S/M`` against the whole of k and v, replicated;
      dk/dv are partial sums over the model axis.

    Returns o (B,S,Hq,D), sharded as q.
    """
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    strategy, bspec, M = attention_strategy(mesh, q.shape, Hkv, rules)
    body = functools.partial(_attend, window=window,
                             attn_softcap=attn_softcap)
    rep = placements_for((bspec,), mesh)
    if strategy in ("local", "kv_heads"):
        hspec = "model" if strategy == "kv_heads" else None
        pl = placements_for((bspec, None, hspec), mesh)
        return local_region(lambda q_, k_, v_: body(q_, k_, v_, 0), mesh,
                            (q, k, v), (pl, pl, pl), pl)
    if strategy == "q_heads":
        Hq_l = Hq // M
        kv_idx = (mesh.get_local_rank("model") * Hq_l) // G

        def local(q_, k_, v_):
            return body(q_, k_[:, :, kv_idx:kv_idx + 1],
                        v_[:, :, kv_idx:kv_idx + 1], 0)
        pl = placements_for((bspec, None, "model"), mesh)
        return local_region(local, mesh, (q, k, v), (pl, rep, rep), pl)
    # strategy == "seq": sequence-parallel q chunks
    off = mesh.get_local_rank("model") * (S // M)
    pl = placements_for((bspec, "model"), mesh)
    return local_region(lambda q_, k_, v_: body(q_, k_, v_, off), mesh,
                        (q, k, v), (pl, rep, rep), pl)


def _all_reduce(x, mesh, axes, op):
    for a in axes:
        torch.distributed.all_reduce(x, op=op, group=mesh.get_group(a))
    return x


def sharded_decode_attention(mesh, q, k_cache, v_cache, kx, vx, pos, *,
                             window: int = 0, attn_softcap: float = 0.0,
                             rules=None):
    """Single-token decode on DTensors over ``mesh``: writes (kx, vx) at
    ``pos`` into the caches, in place, then attends.  The strategy follows
    the rules' resolution of the cache's logical axes ("batch", "seq_kv",
    "kv_heads", "head_dim"), as the reference's:

      - a sharded seq dim: each rank holds a slice of the positions, and
        the softmax merges across them (max, then sums);
      - a sharded head_dim: the partial scores are summed across it.

    Returns (out (B,1,Hq,D), k_cache, v_cache).
    """
    D = k_cache.shape[3]
    rules = rules or PartitionRules()
    spec = rules.spec_for(("batch", "seq_kv", "kv_heads", "head_dim"),
                          k_cache.shape, mesh)
    bspec, seqspec, hspec, dspec = spec + (None,) * (4 - len(spec))
    seq_axes, d_axes = spec_axes(seqspec), spec_axes(dspec)
    scale = D ** -0.5
    p = int(pos)
    coord = 0                       # this rank's slice of the positions
    for a in seq_axes:
        coord = coord * mesh_shape(mesh)[a] + mesh.get_local_rank(a)

    def local(q_, kc, vc, kx_, vx_):
        S_l = kc.shape[1]
        off = coord * S_l
        if 0 <= p - off < S_l:
            kc[:, p - off] = kx_[:, 0]
            vc[:, p - off] = vx_[:, 0]
        Bl, _, Hkv_l, D_l = kc.shape
        qg = q_.reshape(Bl, Hkv_l, q_.shape[2] // Hkv_l, D_l)
        s = torch.einsum("bhgd,bshd->bhgs", qg.float(), kc.float()) * scale
        if d_axes:
            s = _all_reduce(s, mesh, d_axes, torch.distributed.ReduceOp.SUM)
        if attn_softcap:
            s = softcap(s, attn_softcap)
        kv_pos = off + torch.arange(S_l, device=q_.device)
        mask = kv_pos <= p
        if window:
            mask &= kv_pos > (p - window)
        s = torch.where(mask[None, None, None, :], s, NEG_INF)
        m = s.amax(dim=-1)
        if seq_axes:
            m = _all_reduce(m, mesh, seq_axes, torch.distributed.ReduceOp.MAX)
        e = torch.exp(s - m[..., None])
        l = e.sum(dim=-1)
        acc = torch.einsum("bhgs,bshd->bhgd", e.to(vc.dtype), vc).float()
        if seq_axes:
            l = _all_reduce(l, mesh, seq_axes, torch.distributed.ReduceOp.SUM)
            acc = _all_reduce(acc, mesh, seq_axes,
                              torch.distributed.ReduceOp.SUM)
        out = (acc / l.clamp_min(1e-30)[..., None]).to(q_.dtype)
        return out.reshape(Bl, 1, q_.shape[2], D_l)

    cache_pl = placements_for((bspec, seqspec, hspec, dspec), mesh)
    new_pl = placements_for((bspec, None, hspec, dspec), mesh)
    out = local_region(local, mesh, (q, k_cache, v_cache, kx, vx),
                       (new_pl, cache_pl, cache_pl, new_pl, new_pl), new_pl)
    return out, k_cache, v_cache


# ------------------------- full attention layer ------------------------ #

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


def _sharded_project(x, w):
    """x (B,S,d) @ w (d,H,hd) on DTensors, as each rank's local matmul: x
    keeps its batch sharding, w is gathered on d (its FSDP axis) and keeps
    its heads' or head_dim's sharding, which the output (B,S,H,hd) takes.
    DTensor's own einsum flattens (H, hd) into one dim and cannot split it
    back where hd is sharded (the rules' fallback when the heads do not
    divide)."""
    from torch.distributed.tensor import Replicate, Shard
    rep = Replicate()
    x_pl = tuple(p if p == Shard(0) else rep for p in x.placements)
    w_pl = tuple(p if p in (Shard(1), Shard(2)) else rep for p in w.placements)
    out_pl = tuple(Shard(0) if a == Shard(0) else
                   Shard(b.dim + 1) if isinstance(b, Shard) else rep
                   for a, b in zip(x_pl, w_pl))
    return local_region(_project, x.device_mesh, (x, w), (x_pl, w_pl), out_pl)


def attention_layer(cfg, w, x, *, local: bool, sctx=NULL_CTX, positions=None,
                    cache: Optional[AttnCache] = None, pos=None,
                    use_pallas: bool = False):
    """Pre-norm attention mixer.  Returns (out, new_cache).

    Train/prefill: cache is None -> flash attention over x itself, through
    ``ops.blockwise_attention`` when grad is enabled and the forward-only
    ``ops.flash_attention`` otherwise; the produced K/V are returned as the
    new cache.  Decode: cache given, x is (B, 1, D),
    ``pos`` the write index; K/V are written into the given cache in place
    (the reference returns an updated copy) and that cache is returned.
    ``use_pallas`` keeps the reference's signature and changes nothing: the
    kernels run whenever the tensors are on the card.  Under a mesh
    (``sctx.mesh``) x and the weights are DTensors, q is placed on
    ("batch", "seq", "heads", "head_dim") and the output on ("batch",
    "seq", None), as in the reference, and attention goes through
    :func:`sharded_flash_attention` or :func:`sharded_decode_attention`.
    """
    window = cfg.sliding_window if local else 0
    B, S, _ = x.shape
    proj = _project if sctx.mesh is None else _sharded_project
    q = proj(x, w["wq"])
    kx = proj(x, w["wk"])
    vx = proj(x, w["wv"])
    if positions is None:
        positions = (torch.arange(S, device=x.device) if pos is None
                     else torch.full((S,), int(pos), device=x.device))
        positions = positions.expand(B, S)
    q = apply_rope(q, positions, cfg.rope_theta)
    kx = apply_rope(kx, positions, cfg.rope_theta)
    if sctx.mesh is not None:
        return _sharded_layer(cfg, w, sctx, q, kx, vx, window, cache, pos)

    if cache is None:
        if torch.is_grad_enabled():
            out = ops.blockwise_attention(q, kx, vx, 0, True, window,
                                          cfg.attn_softcap)
        else:
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


def _sharded_layer(cfg, w, sctx, q, kx, vx, window, cache, pos):
    """The rest of :func:`attention_layer` under a mesh, on DTensors."""
    q = sctx.act(q, ("batch", "seq", "heads", "head_dim"))
    if cache is None:
        out = sharded_flash_attention(sctx.mesh, q, kx, vx, window=window,
                                      attn_softcap=cfg.attn_softcap,
                                      rules=sctx.rules)
        new_cache = AttnCache(kx, vx)
    else:
        out, kc, vc = sharded_decode_attention(
            sctx.mesh, q, cache.k, cache.v, kx, vx, pos, window=window,
            attn_softcap=cfg.attn_softcap, rules=sctx.rules)
        new_cache = AttnCache(kc, vc)
    out = torch.einsum("bshk,hkd->bsd", out, w["wo"])
    return sctx.act(out, ("batch", "seq", None)), new_cache
