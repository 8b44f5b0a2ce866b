"""Capacity-based top-k Mixture-of-Experts (GShard/Switch lineage).

Port of ``repro.models.moe``.  Two dispatch modes, chosen by
``cfg.moe_dispatch``:

* ``einsum`` -- the one-hot dispatch and combine products of GShard.  The
  default, and what every config runs.
* ``gather`` -- token->slot indices from the same positions, tokens moved
  by gather and combined by gather: the same function without the
  dispatch and combine products.

Tokens are routed in groups of ``group_size``, each with its own capacity
C per expert; an assignment past C is dropped (its gate is 0).  The
products are ``torch`` ops, as the reference leaves them to XLA: no
kernel of the port runs here.  Under a mesh the tensors are DTensors and
``sctx.act`` places them as the reference's calls do: token groups on the
batch axes, experts on the model axis; without one ``act`` is the
identity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import trace
from ..sharding.partition import NULL_CTX, local_region


def moe_params_spec(cfg):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    spec = {
        "router": ((d, e), ("embed_w", None)),
        "wi": ((e, d, f), ("expert", "expert_embed", "expert_ff")),
        "wo": ((e, f, d), ("expert", "expert_ff", "expert_embed")),
    }
    if cfg.gated_mlp:
        spec["wg"] = ((e, d, f), ("expert", "expert_embed", "expert_ff"))
    return spec


def _one_hot(idx, n):
    """``F.one_hot(idx, n)`` as booleans, from the same ops on every
    device (``F.one_hot`` takes a different decomposition on the CPU, on
    CUDA and on meta, so a step counted on one would not count as on
    another)."""
    return idx.unsqueeze(-1) == torch.arange(n, device=idx.device)


def _router_logits(x, router_w):
    return torch.einsum("gtd,de->gte", x, router_w.to(x.dtype))


def _router_probs(x, router_w):
    """x: (G, T, D) -> f32 softmax over the experts, from logits in x's
    dtype."""
    return torch.softmax(_router_logits(x, router_w).float(), dim=-1)


def _sharded_router_probs(x, router_w):
    """:func:`_router_probs` on DTensors: the logits are each rank's local
    product, the router gathered and x's groups split as given (DTensor's
    own einsum takes a strided split in its backward, whose planning costs
    seconds)."""
    from torch.distributed.tensor import Replicate, Shard
    rep = Replicate()
    x_pl = tuple(p if p == Shard(0) else rep for p in x.placements)
    logits = local_region(_router_logits, x.device_mesh, (x, router_w),
                          (x_pl, (rep,) * len(x_pl)), x_pl)
    return torch.softmax(logits.float(), dim=-1)


def _gates_at(probs, idx, E):
    """Gates of the choices ``idx`` (G, T, k), renormalized, and the Switch
    load-balancing loss E * sum(frac_tokens * frac_prob) from the first
    choice.  Returns (gates, idx, aux) as :func:`_route` does."""
    gates = probs.gather(-1, idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    me = _one_hot(idx[..., 0], E).float().mean(dim=(0, 1))
    ce = probs.mean(dim=(0, 1))
    return gates, idx, E * (me * ce).sum()


def _route(x, router_w, cfg):
    """x: (G, T, D) -> gates (G, T, k) f32, idx (G, T, k), aux
    (:func:`_choose` of the router's probabilities)."""
    return _choose(_router_probs(x, router_w), cfg)


def _choose(probs, cfg):
    """The k largest probabilities, the lower expert first among equal
    ones (``jax.lax.top_k``'s order; ``torch.topk`` promises none, a
    stable sort does): gates, idx, aux."""
    idx = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[..., :cfg.num_experts_per_tok]
    return _gates_at(probs, idx, cfg.num_experts)


def _positions(idx, E, C):
    """Slot position of each (token, k) assignment within its expert.

    idx: (G, T, k) int.  Returns pos (G, T, k) int (>= C means dropped).
    Priority: slot order then token order (GShard).
    """
    G, T, K = idx.shape
    flat = idx.transpose(1, 2).reshape(G, K * T)             # k-major priority
    pos_flat = _one_hot(flat, E).cumsum(dim=1) - 1          # (G, KT, E)
    pos_flat = pos_flat.gather(2, flat[..., None])[..., 0]
    return pos_flat.reshape(G, K, T).transpose(1, 2)         # (G, T, k)


def _capacity(Tg, K, E, capacity_factor):
    """Slots per expert for a group of Tg tokens: ceil(Tg*K*cf / E) rounded
    up to a multiple of 4, at least 4, at most Tg*K."""
    C = int(-(-Tg * K * capacity_factor // E))               # ceil
    C = max(4, (C + 3) // 4 * 4)
    return min(C, Tg * K)


def _expert_ffn(xe, w, gated):
    """xe: (G, E, C, D) -> (G, E, C, D) through per-expert MLP."""
    h = torch.einsum("gecd,edf->gecf", xe, w["wi"])
    if gated:
        g = torch.einsum("gecd,edf->gecf", xe, w["wg"])
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    return torch.einsum("gecf,efd->gecd", h, w["wo"])


def _sharded_expert_ffn(xe, w, gated):
    """:func:`_expert_ffn` on DTensors, as each rank's local products: the
    weights keep their experts' split and are gathered on their other
    dims, xe (G, E, C, D) takes the experts' split and keeps its groups'.
    DTensor's own einsums leave a local view in the backward that the
    local strides cannot take (qwen3-moe at full width on a 16 x 16
    mesh)."""
    from torch.distributed.tensor import Replicate, Shard
    names = ["wi", "wg", "wo"] if gated else ["wi", "wo"]
    e_pl = tuple(p if p == Shard(0) else Replicate()
                 for p in w["wi"].placements)
    x_pl = tuple(Shard(1) if e == Shard(0) else
                 p if p == Shard(0) else Replicate()
                 for p, e in zip(xe.placements, e_pl))

    def body(x_, *ws):
        return _expert_ffn(x_, dict(zip(names, ws)), gated)
    return local_region(body, xe.device_mesh, (xe, *(w[n] for n in names)),
                        (x_pl,) + (e_pl,) * len(names), x_pl)


def _combine(comb, ye):
    """comb (G, T, E, C) x ye (G, E, C, D) -> (G, T, D)."""
    return torch.einsum("gtec,gecd->gtd", comb, ye)


def _sharded_combine(comb, ye):
    """:func:`_combine` on DTensors, as each rank's local product over its
    experts: a partial sum where the experts are split, the groups' split
    kept.  DTensor's own einsum flattens (E, C) with E split into a
    strided split whose placement planning costs seconds a call."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    c_pl, y_pl, o_pl = [], [], []
    for p in comb.placements:
        if p == Shard(2):
            c_pl.append(p), y_pl.append(Shard(1)), o_pl.append(Partial())
        elif p == Shard(0):
            c_pl.append(p), y_pl.append(p), o_pl.append(p)
        else:
            c_pl.append(Replicate()), y_pl.append(Replicate())
            o_pl.append(Replicate())
    return local_region(_combine, comb.device_mesh, (comb, ye),
                        (tuple(c_pl), tuple(y_pl)), tuple(o_pl))


def moe_ffn(x, w, cfg, sctx=NULL_CTX, group_size: int = 4096):
    """x: (B, S, D) -> (B, S, D).  Returns (out, aux_loss).

    The B*S tokens split into g = B*S // min(group_size, B*S) groups;
    where they do not split evenly the reference fails in its reshape, and
    this raises ValueError.

    The ``gather`` dispatch scatters only the kept assignments: the
    reference also scatters each dropped one, to slot (E-1, C-1), where a
    kept token may sit, and which write lands there is undefined
    (ROADMAP queue 3).  So ``gather`` here equals ``einsum`` whether or not
    an expert overflows.
    """
    B, S, D = x.shape
    T = B * S
    g = max(1, T // min(group_size, T))
    Tg = T // g
    if g * Tg != T:
        raise ValueError(f"moe_ffn: {T} tokens do not split into {g} groups "
                         f"of {Tg} (group_size {group_size})")
    # under a mesh x is first placed as a layer's output: DTensor's own
    # choice for it (the sequence over the model axis, from the norm) is
    # one whose (g, Tg) view it cannot take back in the backward
    x = sctx.act(x, ("batch", "seq", None))
    xg = sctx.act(x.reshape(g, Tg, D), ("batch", None, None))

    E, K = cfg.num_experts, cfg.num_experts_per_tok
    C = _capacity(Tg, K, E, cfg.capacity_factor)

    with trace.span("moe.route"):
        if sctx.mesh is None:
            gates, idx, aux = _route(xg, w["router"], cfg)
        else:
            gates, idx, aux = _choose(_sharded_router_probs(xg, w["router"]),
                                      cfg)
    with trace.span("moe.positions"):
        pos = _positions(idx, E, C)                          # (G, T, k)
    keep = pos < C
    gates = gates * keep

    if cfg.moe_dispatch == "einsum":
        # dispatch (G, T, E, C) one-hot; combine = dispatch * per-token gate
        oh_e = _one_hot(idx, E).to(xg.dtype)                          # (G,T,k,E)
        oh_c = _one_hot(torch.where(keep, pos, C), C + 1).to(
            xg.dtype)[..., :-1]                                        # (G,T,k,C)
        disp = torch.einsum("gtke,gtkc->gtec", oh_e, oh_c)
        disp = sctx.act(disp, ("batch", None, "expert", None))
        xe = torch.einsum("gtec,gtd->gecd", disp, xg)
        xe = sctx.act(xe, ("batch", "expert", None, None))
        with trace.span("moe.experts"):
            ye = (_expert_ffn if sctx.mesh is None else _sharded_expert_ffn)(
                xe, w, cfg.gated_mlp)
        ye = sctx.act(ye, ("batch", "expert", None, None))
        comb = torch.einsum("gtke,gtkc,gtk->gtec", oh_e, oh_c,
                            gates.to(xg.dtype))
        comb = sctx.act(comb, ("batch", None, "expert", None))
        out = (_combine if sctx.mesh is None else _sharded_combine)(comb, ye)
    else:  # gather dispatch: zero-FLOP data movement
        tok = torch.arange(Tg, device=x.device)[None, :, None].expand_as(idx)
        # slot e*C + pos of each kept assignment; the dropped ones all go
        # to one spare slot E*C, cut away below.  Tg = "no token"
        slot = torch.where(keep, idx * C + pos, E * C)
        slot_src = torch.full((g, E * C + 1), Tg, dtype=torch.long,
                              device=x.device)
        slot_src.scatter_(1, slot.reshape(g, Tg * K), tok.reshape(g, Tg * K))
        xpad = torch.cat([xg, xg.new_zeros(g, 1, D)], dim=1)
        xe = torch.take_along_dim(
            xpad, slot_src[:, :E * C, None], dim=1).reshape(g, E, C, D)
        xe = sctx.act(xe, ("batch", "expert", None, None))
        with trace.span("moe.experts"):
            ye = (_expert_ffn if sctx.mesh is None else _sharded_expert_ffn)(
                xe, w, cfg.gated_mlp)
        ypad = ye.reshape(g, E * C, D)
        flat_slot = idx * C + torch.where(keep, pos, 0)      # (G, T, k)
        yk = torch.take_along_dim(
            ypad, flat_slot.reshape(g, Tg * K, 1), dim=1).reshape(g, Tg, K, D)
        out = torch.einsum("gtkd,gtk->gtd", yk, gates.to(yk.dtype))

    return sctx.act(out.reshape(B, S, D), ("batch", "seq", None)), aux
