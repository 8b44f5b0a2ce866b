"""LM assembly: embeddings, tied head, loss, and the step factories.

Port of ``repro.models.model``: ``make_train_step``, ``make_prefill_step``
and ``make_decode_step`` return plain functions over (params, inputs), the
task bodies of the train and serve loops.  Prefill
and decode run every layer kind of ``transformer``: attention, Mamba2,
dense and MoE FFNs, and so does training: attention through the flash
kernels forward (K1 with its lse) and backward (K1b), Mamba2 through the
SSD chunk kernels forward (K2) and backward (K2b), MoE through ``torch``
ops, with the MoE layers' load-balancing loss added to the loss.  The
``vision_stub`` frontend puts the patches, through the connector MLP, in
front of the token embeddings, and the loss runs over the text positions
only; the ``audio_stub`` frontend adds nothing, as in the reference.

Each factory takes a ``ShardCtx``.  Under a ``DeviceMesh`` the params are
DTensors (``params.shard_tree``), the batch plain tensors (the global
batch, replicated) or DTensors, and the model's ops run on DTensors, with
constants such as positions treated as replicated
(``implicit_replication``); the metrics come back as plain tensors, the
grads as DTensors placed as their params.  With ``NULL_CTX`` (no mesh) the
steps run exactly as they did before sharding was ported.
``auto_microbatches`` and ``input_specs``/``input_axes`` belong to the
dry-run and are not ported yet (ROADMAP queue 1 item 15).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import torch_dtype
from ..sharding.partition import NULL_CTX, ShardCtx
from ..tree import flatten, tree_map, unflatten
from . import transformer
from .layers import softcap


def on_mesh(sctx: ShardCtx):
    """The context the model's ops run in: under a mesh, plain tensors
    (positions, masks, the replicated batch) meet DTensors as replicated
    ones; without a mesh, nothing."""
    if sctx.mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def full(t):
    """A DTensor's whole value as a plain tensor; a plain tensor as is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def embed_inputs(cfg, params, batch, sctx: ShardCtx = NULL_CTX):
    """Token (+ stub-frontend) embedding.  Returns (B, S_total, D) embeds in
    the model's dtype: for ``vision_stub`` with ``patches`` (B, nfe, D) in
    the batch, the patches through the connector MLP (tanh GELU, as
    ``jax.nn.gelu``'s default) in front of the token embeddings.  Under a
    mesh the lookup is ``F.embedding`` (the op DTensor shards) and the
    result is placed on ("batch", "seq", None)."""
    if sctx.mesh is None:
        x = params["embed"][batch["tokens"].long()]
    else:
        x = F.embedding(batch["tokens"].long(), params["embed"])
    x = x.to(torch_dtype(cfg.dtype))
    if cfg.frontend == "vision_stub" and "patches" in batch:
        w = params["connector"]
        p = batch["patches"].to(x.dtype) @ w["wi"]
        p = F.gelu(p, approximate="tanh") @ w["wo"]
        x = torch.cat([p, x], dim=1)
    return sctx.act(x, ("batch", "seq", None))


def lm_logits(cfg, params, hidden):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = hidden @ head.to(hidden.dtype)
    return softcap(logits, cfg.logit_softcap)


def make_prefill_step(cfg, sctx: ShardCtx = NULL_CTX, use_pallas: bool = False):
    """(params, batch) -> (last-token logits (B,1,V), cache); under a mesh
    both as DTensors."""
    @torch.no_grad()
    def prefill_step(params, batch):
        with on_mesh(sctx):
            x = embed_inputs(cfg, params, batch, sctx)
            hidden, cache, _ = transformer.forward(
                cfg, params, x, mode="prefill", sctx=sctx,
                use_pallas=use_pallas)
            return lm_logits(cfg, params, hidden[:, -1:]), cache
    return prefill_step


def make_decode_step(cfg, sctx: ShardCtx = NULL_CTX, use_pallas: bool = False):
    """(params, token (B,1), cache, pos) -> (logits (B,1,V), cache).

    The cache is updated in place and returned."""
    @torch.no_grad()
    def decode_step(params, token, cache, pos):
        with on_mesh(sctx):
            x = embed_inputs(cfg, params, {"tokens": token}, sctx)
            hidden, cache, _ = transformer.forward(
                cfg, params, x, mode="decode", sctx=sctx, cache=cache,
                pos=pos, use_pallas=use_pallas)
            return lm_logits(cfg, params, hidden), cache
    return decode_step


# ------------------------------- loss ---------------------------------- #

def _xent_block(cfg, params, hidden, targets, mask):
    logits = lm_logits(cfg, params, hidden).float()
    logz = torch.logsumexp(logits, dim=-1)
    if hasattr(logits, "placements"):
        # a DTensor, its vocab maybe sharded: the target's logit as a sum
        # against its one-hot row (the one nonzero term, exactly), which
        # shards as the logits do
        gold = (logits * F.one_hot(targets.long(), logits.shape[-1])).sum(-1)
    else:
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

def loss_fn(cfg, params, batch, sctx: ShardCtx = NULL_CTX,
            use_pallas: bool = False):
    x = embed_inputs(cfg, params, batch, sctx)
    hidden, _, aux = transformer.forward(cfg, params, x, mode="train",
                                         sctx=sctx, use_pallas=use_pallas)
    if cfg.frontend == "vision_stub" and "patches" in batch:
        # the patches occupy the prefix: the loss is over text positions only
        hidden = hidden[:, batch["patches"].shape[1]:]
    loss = lm_loss(cfg, params, hidden, batch["targets"], batch["loss_mask"])
    if cfg.num_experts:
        loss = loss + 0.01 * aux
    return loss, {"loss": loss, "aux": aux}


def _placed_like(g, p):
    """Gradient ``g`` placed as its param ``p`` (a DTensor's placements)."""
    if getattr(p, "placements", None) is None or g.placements == p.placements:
        return g
    return g.redistribute(p.device_mesh, p.placements)


def make_loss_and_grad(cfg, sctx: ShardCtx = NULL_CTX,
                       use_pallas: bool = False):
    """(params, batch) -> (grads, metrics): grads in the params' structure
    and dtypes (under a mesh DTensors placed as their params), metrics
    {"loss", "aux"} detached plain tensors."""
    def f(params, batch):
        leaves, structure = flatten(params)
        leaves = [p.detach().requires_grad_() for p in leaves]
        with on_mesh(sctx):
            loss, metrics = loss_fn(cfg, unflatten(structure, leaves), batch,
                                    sctx, use_pallas)
            grads = torch.autograd.grad(loss, leaves)
            if sctx.mesh is not None:
                grads = [_placed_like(g, p) for g, p in zip(grads, leaves)]
        return (unflatten(structure, list(grads)),
                {k: full(v).detach() for k, v in metrics.items()})
    return f


def make_train_step(cfg, optimizer, sctx: ShardCtx = NULL_CTX,
                    use_pallas: bool = False, microbatches: int = 1,
                    grad_dtype: str = "float32"):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``microbatches`` > 1 accumulates gradients over that many slices of the
    batch along dim 0, in ``grad_dtype``; under a mesh the accumulators are
    pinned to the params' placements (``transformer.param_pspecs``), as the
    reference pins them.  The optimizer updates params and moments in place
    (``AdamW.update``) and the step returns them.
    """
    loss_and_grad = make_loss_and_grad(cfg, sctx, use_pallas)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            grads, metrics = loss_and_grad(params, batch)
        else:
            dt = torch_dtype(grad_dtype)
            gacc = tree_map(lambda p: torch.zeros_like(p, dtype=dt), params)
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
