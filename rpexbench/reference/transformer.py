"""Plain reference of the dense decoder (GQA attention, gated MLP).

A layer: RMSNorm; q, k, v projections (Hq query heads on Hkv key-value
heads of D); rotary embedding on q and k with adjacent pairs (dims 2i and
2i+1) at frequency theta^(-2i/D); causal softmax attention with each
group of Hq/Hkv query heads on one kv head, scores scaled by D^-1/2; the
output projection; the residual; RMSNorm; SiLU(x Wg) * (x Wi) times Wo;
the residual.  The head is untied unless the configuration ties it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import head_leaves, rms_norm


def leaves(m: dict):
    """Every weight as (path, shape, init); q, k and v draw N(0, 1/d_model)
    (fan_in the model width, so that attention at full width is not a hard
    argmax)."""
    d, Hq, Hkv, hd, f = (m["d_model"], m["num_heads"], m["num_kv_heads"],
                         m["head_dim"], m["d_ff"])
    out = head_leaves(m)
    for i in range(m["num_layers"]):
        pre = f"layers.{i}."
        out += [(pre + "norm1", (d,), ("zeros",)),
                (pre + "mixer.wq", (d, Hq, hd), ("normal", d)),
                (pre + "mixer.wk", (d, Hkv, hd), ("normal", d)),
                (pre + "mixer.wv", (d, Hkv, hd), ("normal", d)),
                (pre + "mixer.wo", (Hq, hd, d), ("normal", Hq * hd)),
                (pre + "norm2", (d,), ("zeros",)),
                (pre + "ffn.wi", (d, f), ("normal", d)),
                (pre + "ffn.wg", (d, f), ("normal", d)),
                (pre + "ffn.wo", (f, d), ("normal", f))]
    return out


def rope(x, theta):
    """x (b, s, h, D) rotated by position, pairs (2i, 2i+1)."""
    s, D = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                         device=x.device) / D)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def attention(q, k, v):
    """Causal softmax attention, one batch row at a time: q (b, s, Hq, D),
    k and v (b, s, Hkv, D)."""
    b, s, Hq, D = q.shape
    G = Hq // k.shape[2]
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    rows = []
    for r in range(b):
        kr = k[r].repeat_interleave(G, dim=1)              # s Hq D
        vr = v[r].repeat_interleave(G, dim=1)
        sc = torch.einsum("ihd,jhd->hij", q[r], kr) * D ** -0.5
        p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
        rows.append(torch.einsum("hij,jhd->ihd", p, vr))
    return torch.stack(rows)


def layer(m, params, i, x, prec):
    w = lambda k: params[f"layers.{i}.{k}"]
    d, Hq, Hkv, hd = (m["d_model"], m["num_heads"], m["num_kv_heads"],
                      m["head_dim"])
    b, s, _ = x.shape
    h = rms_norm(x, w("norm1"), m["norm_eps"])
    q = prec.mm(h, w("mixer.wq").reshape(d, Hq * hd)).reshape(b, s, Hq, hd)
    k = prec.mm(h, w("mixer.wk").reshape(d, Hkv * hd)).reshape(b, s, Hkv, hd)
    v = prec.mm(h, w("mixer.wv").reshape(d, Hkv * hd)).reshape(b, s, Hkv, hd)
    theta = m["rope_theta"]
    o = attention(rope(q, theta), rope(k, theta), v)
    x = x + prec.mm(o.reshape(b, s, Hq * hd), w("mixer.wo").reshape(Hq * hd, d))
    h = rms_norm(x, w("norm2"), m["norm_eps"])
    g = F.silu(prec.mm(h, w("ffn.wg"))) * prec.mm(h, w("ffn.wi"))
    return x + prec.mm(g, w("ffn.wo"))
