"""Plain reference of the attention-free Mamba2 (SSD) model.

A layer: RMSNorm; one input projection to z, xBC and dt; dt = softplus(dt
+ dt_bias); A = -exp(A_log); a depthwise causal convolution of width W
over xBC and SiLU; the SSD scan of x (heads of P) with B and C (N, shared
by the heads):

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,    y_t = h_t C_t + D x_t

in its chunked form (chunk Q: the pairs inside a chunk by their decays,
then the chunk states and the recurrence between chunks; the log-decays
summed and differenced in float64); y times SiLU(z); the output
projection; the residual.  The embedding is tied to the head.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import rms_norm


def leaves(m: dict):
    """Every weight as (path, shape, init): ("normal", fan_in) draws
    N(0, 1/fan_in), ("zeros",) a norm's delta, ("dt_bias",), ("A_log",) and
    ("ones",) Mamba2's published init of dt, A and D (float32 leaves)."""
    from .common import head_leaves
    d = m["d_model"]
    inner = m.get("d_inner") or 2 * d
    N, P, W = m["ssm_state"], m["ssm_head_dim"], m["conv_width"]
    H = inner // P
    out = head_leaves(m)
    for i in range(m["num_layers"]):
        pre = f"layers.{i}."
        out += [(pre + "norm1", (d,), ("zeros",)),
                (pre + "mixer.in_proj", (d, 2 * inner + 2 * N + H),
                 ("normal", d)),
                (pre + "mixer.out_proj", (inner, d), ("normal", inner)),
                (pre + "mixer.conv_w", (W, inner + 2 * N), ("normal", W)),
                (pre + "mixer.A_log", (H,), ("A_log",)),
                (pre + "mixer.D", (H,), ("ones",)),
                (pre + "mixer.dt_bias", (H,), ("dt_bias",))]
    return out


def segsum(a):
    """exp-ready pairwise sums: out[..., i, j] = sum_{j < t <= i} a[..., t]
    for j <= i and -inf above the diagonal (float64 in, float64 out)."""
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    n = a.shape[-1]
    mask = torch.ones(n, n, dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd(x, dt, A, B_, C_, chunk: int):
    """y (b, s, h, p) of the scan from a zero state; x (b, s, h, p), dt (b,
    s, h), A (h,), B_ and C_ (b, s, n), all float32."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    q = min(chunk, s)
    c = s // q
    X = (x * dt[..., None]).reshape(b, c, q, h, p)
    a = (dt * A).double().reshape(b, c, q, h).permute(0, 3, 1, 2)  # b h c q
    Bc, Cc = B_.reshape(b, c, q, n), C_.reshape(b, c, q, n)
    L = torch.exp(segsum(a)).float()                                # b h c q q
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    y = torch.einsum("bhcij,bcjhp->bcihp", L * CB[:, None], X)
    cum = torch.cumsum(a, dim=-1)                                   # b h c q
    to_end = torch.exp(cum[..., -1:] - cum).float()
    states = torch.einsum("bcjn,bhcj,bcjhp->bchpn", Bc, to_end, X)
    total = cum[..., -1]                                            # b h c
    state = torch.zeros(b, h, p, n, dtype=x.dtype, device=x.device)
    ys = []
    from_start = torch.exp(cum).float()                             # b h c q
    for k in range(c):
        ys.append(torch.einsum("bin,bhpn,bhi->bihp", Cc[:, k], state,
                               from_start[:, :, k]))
        state = (state * torch.exp(total[:, :, k]).float()[..., None, None]
                 + states[:, k])
    return (y + torch.stack(ys, dim=1)).reshape(b, s, h, p)


def conv(xBC, w):
    """Depthwise causal convolution of width W over the sequence."""
    W, S = w.shape[0], xBC.shape[1]
    xp = F.pad(xBC, (0, 0, W - 1, 0))
    return sum(xp[:, i:i + S] * w[i] for i in range(W))


def layer(m, params, i, x, prec):
    w = lambda k: params[f"layers.{i}.{k}"]
    d = m["d_model"]
    inner = m.get("d_inner") or 2 * d
    N, P = m["ssm_state"], m["ssm_head_dim"]
    H = inner // P
    b, s, _ = x.shape
    hdn = rms_norm(x, w("norm1"), m["norm_eps"])
    z, xBC, dt = torch.split(prec.mm(hdn, w("mixer.in_proj")),
                             [inner, inner + 2 * N, H], dim=-1)
    dt = dt + w("mixer.dt_bias")
    dt = torch.logaddexp(dt, torch.zeros_like(dt))              # softplus
    A = -torch.exp(w("mixer.A_log"))
    xBC = F.silu(conv(xBC, w("mixer.conv_w")))
    xs, B_, C_ = torch.split(xBC, [inner, N, N], dim=-1)
    xh = xs.reshape(b, s, H, P)
    y = ssd(xh, dt, A, B_, C_, m["ssm_chunk"]) + xh * w("mixer.D")[:, None]
    y = y.reshape(b, s, inner) * F.silu(z)
    return x + prec.mm(y, w("mixer.out_proj"))
