"""Transformer assembly: param specs, init, caches, and the layer loop.

Port of ``repro.models.transformer``: attention and Mamba2 mixers, dense
and MoE FFNs, in any layer program (jamba: a period of 8, seven mamba
layers and one attention layer, MoE on odd positions).  A Python loop over
the layers takes the place of the reference's ``lax.scan`` over stacked
groups, so the port keeps one parameter dict per layer;
``repro_torch.params`` converts between that layout and the reference's
stacked ``(G, ...)`` one.  Remat in train mode is ``torch.utils.checkpoint``
per layer; the XLA barrier ``_pin`` has no counterpart here.  Every layer
kind trains: attention through the flash kernels K1 and K1b, Mamba2
through the SSD kernels K2 and K2b, MoE FFNs through ``torch`` ops.

Sharding: ``param_axes``, ``param_pspecs`` and ``cache_axes`` give each
leaf's logical axes and its spec on a mesh (one entry per layer, without
the reference's leading ``"layers"`` axis, which resolves to no mesh axis),
and ``forward`` threads a ``ShardCtx`` to the layers, which place their
activations as the reference's ``act`` calls do.  With ``NULL_CTX`` (no
mesh) nothing of it runs.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import trace
from ..device import resolve_device, torch_dtype
from ..sharding.partition import NULL_CTX, PartitionRules
from .attention import AttnCache, attention_layer, attn_params_spec
from .layers import mlp, rms_norm
from .mamba2 import MambaCache, mamba_layer, mamba_params_spec
from .moe import moe_ffn, moe_params_spec

LayerCache = Union[AttnCache, MambaCache]


# --------------------------- layer program ----------------------------- #

def layer_program(cfg) -> List[Tuple[str, str]]:
    return [(cfg.layer_kind(i), cfg.ffn_kind(i)) for i in range(cfg.num_layers)]


def program_period(cfg) -> int:
    prog = layer_program(cfg)
    L = len(prog)
    for p in range(1, L + 1):
        if L % p == 0 and all(prog[i] == prog[i % p] for i in range(L)):
            return p
    return L


# ----------------------------- param specs ------------------------------ #

def _dense_ffn_spec(cfg):
    d, f = cfg.d_model, cfg.d_ff
    s = {"wi": ((d, f), ("embed_w", "mlp")), "wo": ((f, d), ("mlp", "embed_w"))}
    if cfg.gated_mlp:
        s["wg"] = ((d, f), ("embed_w", "mlp"))
    return s


def sublayer_spec(cfg, mixer: str, ffn: str):
    d = cfg.d_model
    spec: Dict[str, Any] = {"norm1": ((d,), ("embed_w",))}
    if mixer in ("attn", "local_attn"):
        spec["mixer"] = attn_params_spec(cfg)
    else:
        spec["mixer"] = mamba_params_spec(cfg)
    if ffn != "none":
        spec["norm2"] = ((d,), ("embed_w",))
        spec["ffn"] = moe_params_spec(cfg) if ffn == "moe" else _dense_ffn_spec(cfg)
    return spec


def param_specs(cfg):
    """Spec tree with one entry per layer; leaves are (shape, logical_axes)."""
    d, V = cfg.d_model, cfg.vocab_size
    spec: Dict[str, Any] = {
        "embed": ((V, d), ("vocab", "embed_w")),
        "final_norm": ((d,), ("embed_w",)),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = ((d, V), ("embed_w", "vocab"))
    if cfg.frontend == "vision_stub":               # the patches' connector MLP
        spec["connector"] = {"wi": ((d, d), ("embed_w", "mlp")),
                             "wo": ((d, d), ("mlp", "embed_w"))}
    spec["layers"] = [sublayer_spec(cfg, *kinds) for kinds in layer_program(cfg)]
    return spec


def _is_spec_leaf(x):
    return (isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)
            and all(isinstance(i, int) for i in x[0]))


def _map_spec(fn, tree):
    if _is_spec_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_spec(fn, v) for k, v in tree.items()}
    return [_map_spec(fn, v) for v in tree]


def param_axes(cfg):
    """The logical axes of every leaf, in the params' structure."""
    return _map_spec(lambda leaf: leaf[1], param_specs(cfg))


def param_pspecs(cfg, mesh, rules: Optional[PartitionRules] = None):
    """Each leaf's spec on ``mesh`` (a ``DeviceMesh`` or a ``{axis: size}``
    mapping), in the params' structure: the reference's ``param_pspecs``
    per layer, its stacked layers' leading entry dropped."""
    rules = rules or PartitionRules()
    return _map_spec(lambda leaf: rules.spec_for(leaf[1], leaf[0], mesh),
                     param_specs(cfg))


def abstract_params(cfg, dtype=None):
    """The params as ``meta`` tensors (shape and dtype, no storage), every
    leaf in ``dtype`` (the model's by default), as the reference's
    ``abstract_params`` gives every leaf one dtype."""
    dt = torch_dtype(dtype or cfg.dtype)
    return _map_spec(lambda leaf: torch.empty(leaf[0], dtype=dt,
                                              device="meta"),
                     param_specs(cfg))


def init_params(cfg, seed: int = 0, *, device=None, dtype=None):
    """Random init as in the reference: normal x fan_in^-1/2, zero-delta
    norms, and the mamba ``("ssm_heads",)`` leaves (A_log, D, dt_bias)
    uniform in [0.5, 1.5) in float32 whatever the model's dtype, from a
    ``torch.Generator`` seeded with ``seed`` on ``device``.

    The numbers differ from ``jax.random``'s; parity tests convert the
    reference's params instead (``repro_torch.params``).
    """
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def mk(leaf):
        shape, axes = leaf
        if axes == ("embed_w",):                    # norm scale, stored as delta
            return torch.zeros(shape, dtype=dt, device=dev)
        if axes == ("ssm_heads",):                  # A_log / D / dt_bias
            return 0.5 + torch.rand(shape, generator=gen, dtype=torch.float32,
                                    device=dev)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        if axes[0] == "heads":                      # wo: (H, hd, D), fan_in = H*hd
            fan_in = shape[-3] * shape[-2]
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return (w * (1.0 / math.sqrt(max(1, fan_in)))).to(dt)

    return _map_spec(mk, param_specs(cfg))


# ------------------------------- caches -------------------------------- #

def cache_specs(cfg, batch: int, max_seq: int,
                dtype="bfloat16") -> List[LayerCache]:
    """Abstract decode cache, one entry per layer, as ``meta`` tensors
    (shape and dtype, no storage): an ``AttnCache`` of (B, max_seq, Hkv, D)
    for an attention layer, a ``MambaCache`` of h (B, H, P, N) in f32 and
    conv (B, W-1, inner+2N) in ``dtype`` for a mamba layer."""
    dt = torch_dtype(dtype)
    meta = lambda shape, d=dt: torch.empty(shape, dtype=d, device="meta")
    out = []
    for mixer, _ in layer_program(cfg):
        if mixer in ("attn", "local_attn"):
            shape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
            out.append(AttnCache(meta(shape), meta(shape)))
        else:
            out.append(MambaCache(
                meta((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                     torch.float32),
                meta((batch, cfg.conv_width - 1,
                      cfg.inner_dim + 2 * cfg.ssm_state))))
    return out


def cache_axes(cfg) -> List[LayerCache]:
    """Logical axes of the decode cache's leaves, one entry per layer, as
    :func:`cache_specs` (the reference's without ``"layers"``)."""
    out = []
    for mixer, _ in layer_program(cfg):
        if mixer in ("attn", "local_attn"):
            ax = ("batch", "seq_kv", "kv_heads", "head_dim")
            out.append(AttnCache(ax, ax))
        else:
            out.append(MambaCache(("batch", "ssm_heads", None, "state"),
                                  ("batch", None, "ssm_inner")))
    return out


def init_cache(cfg, batch: int, max_seq: int, dtype="bfloat16", *,
               device=None) -> List[LayerCache]:
    """Zeroed decode cache on ``device``, shaped as :func:`cache_specs`."""
    dev = resolve_device(device)
    return [type(spec)(*(torch.zeros_like(t, device=dev) for t in spec))
            for spec in cache_specs(cfg, batch, max_seq, dtype)]


# ------------------------------- forward ------------------------------- #

# each mixer's and FFN's span name, by its kind (layer.attn, layer.mamba,
# layer.dense, ...), made once: a span allocates nothing while tracing is off
_SPANS = {k: f"layer.{k}" for k in ("attn", "local_attn", "mamba", "dense",
                                     "moe")}


def _apply_sublayer(cfg, kind, ffn, w, x, *, sctx, cache, pos, use_pallas):
    h = rms_norm(x, w["norm1"], cfg.norm_eps)
    with trace.span(_SPANS[kind]):
        if kind in ("attn", "local_attn"):
            mix, new_cache = attention_layer(
                cfg, w["mixer"], h, local=(kind == "local_attn"), sctx=sctx,
                cache=cache, pos=pos, use_pallas=use_pallas)
        else:
            mix, new_cache = mamba_layer(cfg, w["mixer"], h, sctx=sctx,
                                         cache=cache, use_pallas=use_pallas)
    x = x + mix
    aux = None
    if ffn != "none":
        h = rms_norm(x, w["norm2"], cfg.norm_eps)
        with trace.span(_SPANS[ffn]):
            if ffn == "moe":
                out, aux = moe_ffn(h, w["ffn"], cfg, sctx)
            else:
                out = sctx.act(mlp(h, w["ffn"], cfg.gated_mlp, sctx),
                               ("batch", "seq", None))
        x = x + out
    return x, new_cache, aux


def _save_matmuls(ctx, op, *args, **kwargs):
    """remat "dots": keep the matrix products' outputs, recompute the rest
    (the reference's ``checkpoint_dots_with_no_batch_dims``: the
    projections and the MLP; attention's batched products are inside the
    flash kernels, which recompute their own scores)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def forward(cfg, params, embeds, *, mode: str = "prefill", sctx=NULL_CTX,
            cache: Optional[List[LayerCache]] = None, pos=None,
            use_pallas: bool = False):
    """Run the layer stack.  embeds: (B, S, D).

    mode: "train" (no caches; attention differentiable through the flash
    kernels; each layer under ``cfg.remat``: "full" recomputes the layer in
    the backward, "dots" keeps its matrix products, "none" keeps
    everything), "prefill" (emit caches) or "decode" (cache
    in/out, S == 1, ``pos`` = write index of the attention layers; mamba
    layers keep no position).
    Returns (hidden (B,S,D), new_cache or None in train mode, aux_loss:
    the f32 sum of the MoE layers' load-balancing losses, 0 without MoE;
    in train mode each MoE layer's loss comes out of its checkpoint beside
    its hidden state, under every remat mode).  ``sctx``: the mesh and
    rules; under a mesh params, embeds and caches are DTensors.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}")
    if mode == "decode" and cache is None:
        raise ValueError("decode needs a cache")
    remat = cfg.remat
    if mode == "train" and remat not in ("full", "dots", "none"):
        raise ValueError(f"remat {remat!r}")
    x = embeds
    new_cache = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (kind, ffn) in enumerate(layer_program(cfg)):
        sub = functools.partial(
            _apply_sublayer, cfg, kind, ffn, params["layers"][i], sctx=sctx,
            cache=cache[i] if mode == "decode" else None,
            pos=pos, use_pallas=use_pallas)
        if mode != "train" or remat == "none" or not torch.is_grad_enabled():
            x, nc, layer_aux = sub(x)
            if mode != "train":
                new_cache.append(nc)
        else:
            kw = ({"context_fn": functools.partial(
                create_selective_checkpoint_contexts, _save_matmuls)}
                  if remat == "dots" else {})
            # the hidden state and, for an MoE layer, its aux loss
            x, layer_aux = checkpoint(lambda x, sub=sub: sub(x)[::2], x,
                                      use_reentrant=False, **kw)
        if layer_aux is not None:
            aux = aux + layer_aux
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, None if mode == "train" else new_cache, aux
