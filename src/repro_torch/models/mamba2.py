"""Mamba2 (SSD) mixer: chunked prefill scan + O(1) decode.

Port of ``repro.models.mamba2``.  The prefill (no-cache) branch, and
training, always go through ``ops.ssd``, so a CUDA run launches the SSD
chunk kernel (and in the backward the SSD backward kernel) and a CPU run
takes their plain versions.  Under a mesh, ``sharded_ssd`` runs the same
``ops.ssd`` on each rank's shard of heads and batch.  Decode keeps the SSM
state (B,H,P,N) and a rolling conv window, and costs O(1) per token in the
context length.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..sharding.partition import (NULL_CTX, PartitionRules, local_region,
                                  mesh_shape, placements_for, spec_axes)


def mamba_params_spec(cfg):
    d, inner, nh, N = cfg.d_model, cfg.inner_dim, cfg.ssm_heads, cfg.ssm_state
    cw = cfg.conv_width
    return {
        "in_proj": ((d, 2 * inner + 2 * N + nh), ("embed_w", "ssm_inner")),
        "out_proj": ((inner, d), ("ssm_inner", "embed_w")),
        "conv_w": ((cw, inner + 2 * N), (None, "ssm_inner")),
        "A_log": ((nh,), ("ssm_heads",)),
        "D": ((nh,), ("ssm_heads",)),
        "dt_bias": ((nh,), ("ssm_heads",)),
    }


class MambaCache(NamedTuple):
    h: torch.Tensor        # (B, H, P, N) ssm state, f32
    conv: torch.Tensor     # (B, conv_width-1, inner + 2N) rolling conv input


def _split_proj(cfg, zxbcdt):
    inner, N, nh = cfg.inner_dim, cfg.ssm_state, cfg.ssm_heads
    return torch.split(zxbcdt, [inner, inner + 2 * N, nh], dim=-1)


def _causal_conv(xBC, conv_w, prev: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d. xBC: (B, S, C); conv_w: (W, C).

    The terms are summed from i = 0 in the model's dtype, as in the
    reference.  The returned tail is a copy: a view would keep all of
    ``xp`` alive in the decode cache."""
    W = conv_w.shape[0]
    if prev is None:
        prev = torch.zeros((xBC.shape[0], W - 1, xBC.shape[2]),
                           dtype=xBC.dtype, device=xBC.device)
    xp = torch.cat([prev, xBC], dim=1)
    out = sum(xp[:, i:i + xBC.shape[1], :] * conv_w[i][None, None, :]
              for i in range(W))
    return F.silu(out), xp[:, -(W - 1):, :].clone()


def ssd_chunked(x, dt, A, B_, C_, chunk: int, use_pallas: bool = False,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan, always through ``ops.ssd``.

    x: (B, S, H, P); dt: (B, S, H) (post-softplus); A: (H,) (negative);
    B_, C_: (B, S, N).  Returns y: (B, S, H, P), final state (B, H, P, N).
    ``use_pallas`` keeps the reference's signature and changes nothing.
    """
    return ops.ssd(x, dt, A, B_, C_, chunk, h0=h0)


def sharded_ssd(mesh, x, dt, A, B_, C_, chunk: int, use_pallas: bool = False,
                rules=None):
    """The SSD scan on DTensors over ``mesh``: the batch as the rules
    resolve it, the heads on the model axis where H divides by its size;
    each rank runs ``ops.ssd`` (K2 forward, K2b backward) on its shard with
    no collective, as the recurrence couples neither batch rows nor heads.
    Returns (y (B,S,H,P), final state (B,H,P,N)) as DTensors."""
    rules = rules or PartitionRules()
    B, S, H, _ = x.shape
    bres = rules.spec_for(("batch",), (B,), mesh)
    bspec = bres[0] if bres else None
    M = (1 if "model" in spec_axes(bspec)
         else mesh_shape(mesh).get("model", 1))
    hspec = "model" if (M > 1 and H % M == 0) else None
    pl = lambda *spec: placements_for(spec, mesh)
    return local_region(
        lambda x_, dt_, A_, b_, c_: ssd_chunked(x_, dt_, A_, b_, c_, chunk,
                                                use_pallas),
        mesh, (x, dt, A, B_, C_),
        (pl(bspec, None, hspec), pl(bspec, None, hspec), pl(hspec),
         pl(bspec), pl(bspec)),
        (pl(bspec, None, hspec), pl(bspec, hspec)))


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0); torch's softplus switches to the
    # identity above threshold=20, which differs from it by up to 2e-9
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba_layer(cfg, w, x, *, sctx=NULL_CTX,
                cache: Optional[MambaCache] = None, use_pallas: bool = False):
    """Pre-norm Mamba2 mixer. x: (B, S, D). Returns (out, new_cache).

    Prefill: cache is None; the whole sequence goes through the chunked
    scan (:func:`sharded_ssd` under a mesh).  Decode: x is (B, 1, D) and
    the state advances one token.
    """
    B, S, D = x.shape
    inner, N, nh, P = cfg.inner_dim, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = x @ w["in_proj"]
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    dt = _softplus(dt.float() + w["dt_bias"].float())
    A = -torch.exp(w["A_log"].float())                        # (H,)

    if cache is None:
        xBC, conv_tail = _causal_conv(xBC, w["conv_w"])
        # views of xBC with its row stride: the kernel reads them in place
        xs, B_, C_ = torch.split(xBC, [inner, N, N], dim=-1)
        xh = xs.reshape(B, S, nh, P)
        if sctx.mesh is None:
            y, hT = ssd_chunked(xh, dt, A, B_, C_, cfg.ssm_chunk, use_pallas)
        else:
            xh = sctx.act(xh, ("batch", "seq", "ssm_heads", None))
            y, hT = sharded_ssd(sctx.mesh, xh, dt, A, B_, C_, cfg.ssm_chunk,
                                use_pallas, rules=sctx.rules)
        y = y + xh * w["D"].to(y.dtype)[None, None, :, None]
        new_cache = MambaCache(hT.float(), conv_tail)
    else:
        # single-token recurrence: h <- exp(dt*A) h + dt * (B outer x)
        xBC, conv_tail = _causal_conv(xBC, w["conv_w"], prev=cache.conv)
        xs, B_, C_ = torch.split(xBC, [inner, N, N], dim=-1)
        xh = xs.reshape(B, 1, nh, P)[:, 0]                    # (B, H, P)
        dt1 = dt[:, 0]                                        # (B, H)
        decay = torch.exp(dt1 * A[None, :])                   # (B, H)
        dBx = torch.einsum("bh,bn,bhp->bhpn", dt1, B_[:, 0].float(),
                           xh.float())
        h = cache.h * decay[..., None, None] + dBx            # (B, H, P, N)
        y = torch.einsum("bhpn,bn->bhp", h, C_[:, 0].float())
        y = y[:, None].to(x.dtype)                            # (B, 1, H, P)
        y = y + xh[:, None] * w["D"].to(y.dtype)[None, None, :, None]
        new_cache = MambaCache(h, conv_tail)

    y = y.reshape(B, S, inner)
    y = y * F.silu(z)
    return sctx.act(y @ w["out_proj"], ("batch", "seq", None)), new_cache
