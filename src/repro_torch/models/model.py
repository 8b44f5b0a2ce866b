"""LM assembly: embeddings, tied head, loss, and the step factories.

Port of ``repro.models.model`` without its sharding: ``make_train_step``,
``make_prefill_step`` and ``make_decode_step`` return plain functions over
(params, inputs), the task bodies of the train and serve loops.  Prefill
and decode run every layer kind of ``transformer``: attention, Mamba2,
dense and MoE FFNs, and so does training: attention through the flash
kernels forward (K1 with its lse) and backward (K1b), Mamba2 through the
SSD chunk kernels forward (K2) and backward (K2b), MoE through ``torch``
ops, with the MoE layers' load-balancing loss added to the loss.
``auto_microbatches`` and ``input_specs``/``input_axes`` belong to the
dry-run and are not ported yet (ROADMAP queue 1 item 15).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..device import torch_dtype
from ..tree import flatten, tree_map, unflatten
from . import transformer
from .layers import softcap


def embed_inputs(cfg, params, batch):
    """Token embedding.  Returns (B, S, D) embeds in the model's dtype."""
    if cfg.frontend == "vision_stub":
        raise NotImplementedError("the vision_stub frontend is not ported yet "
                                  "(ROADMAP queue 1 item 12)")
    return params["embed"][batch["tokens"].long()].to(torch_dtype(cfg.dtype))


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


# ------------------------------- loss ---------------------------------- #

def _xent_block(cfg, params, hidden, targets, mask):
    logits = lm_logits(cfg, params, hidden).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum(), mask.sum()


def lm_loss(cfg, params, hidden, targets, mask, *, chunk: int = 2048):
    """Cross-entropy, chunked along the sequence so that (B, chunk, V) is
    the largest logits buffer live: each chunk's logits are recomputed in
    the backward rather than kept."""
    B, S, D = hidden.shape
    if S <= chunk or S % chunk:
        nll, denom = _xent_block(cfg, params, hidden, targets, mask)
        return nll / denom.clamp_min(1.0)
    nll = denom = 0.0
    for c in range(0, S, chunk):
        args = (hidden[:, c:c + chunk], targets[:, c:c + chunk],
                mask[:, c:c + chunk])
        if torch.is_grad_enabled():
            n, d = checkpoint(_xent_block, cfg, params, *args,
                              use_reentrant=False)
        else:
            n, d = _xent_block(cfg, params, *args)
        nll, denom = nll + n, denom + d
    return nll / denom.clamp_min(1.0)


# --------------------------- step factories ----------------------------- #

def loss_fn(cfg, params, batch, use_pallas: bool = False):
    x = embed_inputs(cfg, params, batch)
    hidden, _, aux = transformer.forward(cfg, params, x, mode="train",
                                         use_pallas=use_pallas)
    loss = lm_loss(cfg, params, hidden, batch["targets"], batch["loss_mask"])
    if cfg.num_experts:
        loss = loss + 0.01 * aux
    return loss, {"loss": loss, "aux": aux}


def make_loss_and_grad(cfg, use_pallas: bool = False):
    """(params, batch) -> (grads, metrics): grads in the params' structure
    and dtypes, metrics {"loss", "aux"} detached."""
    def f(params, batch):
        leaves, structure = flatten(params)
        leaves = [p.detach().requires_grad_() for p in leaves]
        loss, metrics = loss_fn(cfg, unflatten(structure, leaves), batch,
                                use_pallas)
        grads = torch.autograd.grad(loss, leaves)
        return (unflatten(structure, list(grads)),
                {k: v.detach() for k, v in metrics.items()})
    return f


def make_train_step(cfg, optimizer, use_pallas: bool = False,
                    microbatches: int = 1, grad_dtype: str = "float32"):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``microbatches`` > 1 accumulates gradients over that many slices of the
    batch along dim 0, in ``grad_dtype``.  The optimizer updates params and
    moments in place (``AdamW.update``) and the step returns them.
    """
    loss_and_grad = make_loss_and_grad(cfg, use_pallas)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            grads, metrics = loss_and_grad(params, batch)
        else:
            dt = torch_dtype(grad_dtype)
            gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                                  device=p.device), params)
            stacked = []
            for i in range(microbatches):
                mbatch = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                       + tuple(v.shape[1:]))[i]
                          for k, v in batch.items()}
                g, m = loss_and_grad(params, mbatch)
                tree_map(lambda a, b: a.add_(b.to(dt)), gacc, g)
                stacked.append(m)
            grads = tree_map(lambda g: g / microbatches, gacc)
            metrics = {k: torch.stack([m[k] for m in stacked]).mean()
                       for k in stacked[0]}
        params, opt_state, gnorm = optimizer.update(params, grads, opt_state)
        return params, opt_state, dict(metrics, grad_norm=gnorm)
    return train_step
