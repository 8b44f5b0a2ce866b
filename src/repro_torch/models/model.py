"""LM assembly: embeddings, tied head, and the serving step factories.

Port of the serving part of ``repro.models.model``: ``make_prefill_step``
and ``make_decode_step`` return plain functions over (params, inputs), the
task bodies of the serve loop.  The training step waits for the flash
backward kernel (ROADMAP K1b).
"""
from __future__ import annotations

import torch

from ..device import torch_dtype
from . import transformer
from .layers import softcap


def embed_inputs(cfg, params, batch):
    """Token embedding.  Returns (B, S, D) embeds in the model's dtype."""
    if cfg.frontend == "vision_stub":
        raise NotImplementedError("the vision_stub frontend is not ported yet "
                                  "(ROADMAP queue 1 item 12)")
    return params["embed"][batch["tokens"]].to(torch_dtype(cfg.dtype))


def lm_logits(cfg, params, hidden):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = hidden @ head.to(hidden.dtype)
    return softcap(logits, cfg.logit_softcap)


def make_prefill_step(cfg, use_pallas: bool = False):
    """(params, batch) -> (last-token logits (B,1,V), cache)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        x = embed_inputs(cfg, params, batch)
        hidden, cache, _ = transformer.forward(
            cfg, params, x, mode="prefill", use_pallas=use_pallas)
        return lm_logits(cfg, params, hidden[:, -1:]), cache
    return prefill_step


def make_decode_step(cfg, use_pallas: bool = False):
    """(params, token (B,1), cache, pos) -> (logits (B,1,V), cache).

    The cache is updated in place and returned."""
    @torch.no_grad()
    def decode_step(params, token, cache, pos):
        x = embed_inputs(cfg, params, {"tokens": token})
        hidden, cache, _ = transformer.forward(
            cfg, params, x, mode="decode", cache=cache, pos=pos,
            use_pallas=use_pallas)
        return lm_logits(cfg, params, hidden), cache
    return decode_step
