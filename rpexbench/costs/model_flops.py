"""Model FLOPs a token: 6 x active parameters in training (the backward
twice the forward), 2 x in inference, from a configuration's ``model``
sizes.  The parameter count is the analytic one: embeddings (and an
untied head), per layer the mixer (attention or Mamba2), the FFN (dense,
or the experts a token uses), the norms, and a vision connector."""
from __future__ import annotations


def layer_kind(m: dict, i: int) -> str:
    if m["family"] == "ssm":
        return "mamba"
    every = m.get("attn_every", 0)
    if every:
        return "attn" if i % every == every - 1 else "mamba"
    if m.get("local_global_alternate", False):
        return "local_attn" if i % 2 == 0 else "attn"
    return "attn"


def ffn_kind(m: dict, i: int) -> str:
    experts, d_ff = m.get("num_experts", 0), m["d_ff"]
    if d_ff == 0 and experts == 0:
        return "none"
    every = m.get("moe_every", 1)
    if experts and i % every == every - 1:
        return "moe"
    return "dense" if d_ff else "none"


def active_params(m: dict) -> int:
    d, hd, V = m["d_model"], m["head_dim"], m["vocab_size"]
    gated = m.get("gated_mlp", True)
    mats = 3 if gated else 2
    n = V * d * (1 if m.get("tie_embeddings", False) else 2)
    for i in range(m["num_layers"]):
        if layer_kind(m, i) == "mamba":
            inner = m.get("d_inner") or 2 * d
            N, nh = m["ssm_state"], inner // m.get("ssm_head_dim", 64)
            n += d * (2 * inner + 2 * N + nh) + inner * d
            n += m.get("conv_width", 4) * (inner + 2 * N) + 3 * nh
        else:
            n += 2 * d * m["num_heads"] * hd + 2 * d * m["num_kv_heads"] * hd
        fk = ffn_kind(m, i)
        if fk == "dense":
            n += mats * d * m["d_ff"]
        elif fk == "moe":
            n += d * m["num_experts"]
            n += m["num_experts_per_tok"] * mats * d * m["d_ff"]
        n += d + (d if fk != "none" else 0)
    n += d
    if m.get("frontend", "none") == "vision_stub":
        n += 2 * d * d
    return n


def per_token(m: dict, training: bool) -> float:
    return (6.0 if training else 2.0) * active_params(m)
