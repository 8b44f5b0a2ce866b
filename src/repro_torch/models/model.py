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

``auto_microbatches``, ``input_specs`` and ``input_axes`` serve the
dry-run (``launch.dryrun``): a cell's gradient-accumulation depth, its
inputs as ``meta`` tensors and their logical axes.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import torch_dtype
from ..sharding.partition import NULL_CTX, ShardCtx, local_region, split_rows
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


def _sharded_embed(tokens, table, mesh):
    """The lookup of ``tokens`` in the DTensor ``table`` (V, D), in a
    ``local_region``: the table gathered on D, each rank looks up the
    vocab rows it holds, zero for the others, and the output is a partial
    sum over the mesh dims that split the vocab; the batch keeps the split
    the rules give it where no vocab split takes its mesh dim.  (DTensor's
    own vocab-split ``F.embedding`` gives a masked partial whose gradient
    comes back as a plain partial sum, which it cannot place.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    vocab_dims = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim)
    rows, start = split_rows(table.shape[0], vocab_dims, mesh)

    def lookup(tok, tab):
        idx = tok.long() - start
        hit = (idx >= 0) & (idx < rows)
        out = tab[torch.where(hit, idx, 0)]
        return out * hit[..., None].to(out.dtype)
    tok_pl = tuple(Replicate() if i in vocab_dims else
                   (p if p == Shard(0) else Replicate())
                   for i, p in enumerate(tokens.placements))
    tab_pl = tuple(Shard(0) if i in vocab_dims else Replicate()
                   for i in range(mesh.ndim))
    out_pl = tuple(Partial() if i in vocab_dims else tok_pl[i]
                   for i in range(mesh.ndim))
    return local_region(lookup, mesh, (tokens, table), (tok_pl, tab_pl),
                        out_pl)


def embed_inputs(cfg, params, batch, sctx: ShardCtx = NULL_CTX):
    """Token (+ stub-frontend) embedding.  Returns (B, S_total, D) embeds in
    the model's dtype: for ``vision_stub`` with ``patches`` (B, nfe, D) in
    the batch, the patches through the connector MLP (tanh GELU, as
    ``jax.nn.gelu``'s default) in front of the token embeddings.  Under a
    mesh the lookup is :func:`_sharded_embed` and the result is placed on
    ("batch", "seq", None)."""
    if sctx.mesh is None:
        x = params["embed"][batch["tokens"].long()]
    else:
        x = _sharded_embed(batch["tokens"], params["embed"], sctx.mesh)
    x = x.to(torch_dtype(cfg.dtype))
    if cfg.frontend == "vision_stub" and "patches" in batch:
        w = params["connector"]
        p = batch["patches"].to(x.dtype) @ w["wi"]
        p = F.gelu(p, approximate="tanh") @ w["wo"]
        x = torch.cat([p, x], dim=1)
    return sctx.act(x, ("batch", "seq", None))


def lm_logits(cfg, params, hidden, sctx: ShardCtx = NULL_CTX):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if sctx.mesh is not None:
        logits = _sharded_logits(hidden, head.to(hidden.dtype))
    else:
        logits = hidden @ head.to(hidden.dtype)
    return softcap(logits, cfg.logit_softcap)


def _sharded_logits(hidden, head):
    """hidden (B, S, D) @ head (D, V) on DTensors, as each rank's local
    matmul: hidden keeps its batch split, the head is gathered on D (its
    FSDP axis) and keeps its vocab split, which the logits take.  (DTensor's
    own choice gathered the whole batch's logits on every rank.)"""
    from torch.distributed.tensor import Replicate, Shard
    rep = Replicate()
    h_pl = tuple(p if p == Shard(0) else rep for p in hidden.placements)
    w_pl = tuple(b if b == Shard(1) and a != Shard(0) else rep
                 for a, b in zip(h_pl, head.placements))
    out_pl = tuple(Shard(2) if b == Shard(1) else a
                   for a, b in zip(h_pl, w_pl))
    return local_region(torch.matmul, hidden.device_mesh, (hidden, head),
                        (h_pl, w_pl), out_pl)


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
            return lm_logits(cfg, params, hidden[:, -1:], sctx), cache
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
            return lm_logits(cfg, params, hidden, sctx), cache
    return decode_step


# ------------------------------- loss ---------------------------------- #

def _xent_block(cfg, params, hidden, targets, mask, sctx=NULL_CTX):
    logits = lm_logits(cfg, params, hidden, sctx).float()
    if sctx.mesh is not None:
        logz, gold = _sharded_xent(logits, targets)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum(), mask.sum()


def _sharded_xent(logits, targets):
    """(logsumexp, the target's logit) over the last dim of the DTensor
    ``logits`` (B, S, V), each rank on its own rows of the batch and of
    the vocab, in ``local_region``s: the max over the vocab (held
    constant, so the gradient is the softmax, as ``torch.logsumexp``'s)
    and then the sum of exp(logits - max) and the target's logit, picked
    where it lies in the rank's vocab rows and zero elsewhere, each a
    partial result over the mesh dims that split the vocab, reduced on
    (B, S) alone.  (DTensor's own ``logsumexp``, and the backward of its
    elementwise ops, gathered the whole batch's logits on every rank, and
    a sum against a one-hot row built a (B, S, V) row of the whole vocab
    on every rank.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = logits.device_mesh
    vdim = logits.ndim - 1
    vocab_dims = [i for i, p in enumerate(logits.placements)
                  if p in (Shard(vdim), Shard(-1))]
    rows, start = split_rows(logits.shape[-1], vocab_dims, mesh)
    if not isinstance(targets, DTensor):
        targets = DTensor.from_local(targets, mesh, [Replicate()] * mesh.ndim)
    lg_pl = tuple(Shard(vdim) if i in vocab_dims else
                  (p if p == Shard(0) else Replicate())
                  for i, p in enumerate(logits.placements))
    row_pl = tuple(Shard(0) if p == Shard(0) else Replicate() for p in lg_pl)
    part = lambda op: tuple(Partial(op) if i in vocab_dims else row_pl[i]
                            for i in range(mesh.ndim))
    m = local_region(lambda lg: lg.detach().amax(dim=-1), mesh, (logits,),
                     (lg_pl,), part("max")).redistribute(mesh, row_pl)

    def terms(lg, tg, m_):
        total = torch.exp(lg - m_[..., None]).sum(dim=-1)
        idx = tg.long() - start
        hit = (idx >= 0) & (idx < rows)
        gold = lg.gather(-1, torch.where(hit, idx, 0)[..., None])[..., 0]
        return total, gold * hit.to(gold.dtype)
    total, gold = local_region(terms, mesh, (logits, targets, m),
                               (lg_pl, row_pl, row_pl),
                               (part("sum"), part("sum")))
    return m + torch.log(total), gold


def lm_loss(cfg, params, hidden, targets, mask, *, chunk: int = 2048,
            sctx: ShardCtx = NULL_CTX):
    """Cross-entropy, chunked along the sequence so that (B, chunk, V) is
    the largest logits buffer live: each chunk's logits are recomputed in
    the backward rather than kept."""
    B, S, D = hidden.shape
    if S <= chunk or S % chunk:
        nll, denom = _xent_block(cfg, params, hidden, targets, mask, sctx)
        return nll / denom.clamp_min(1.0)
    nll = denom = 0.0
    for c in range(0, S, chunk):
        args = (hidden[:, c:c + chunk], targets[:, c:c + chunk],
                mask[:, c:c + chunk])
        if torch.is_grad_enabled():
            n, d = checkpoint(_xent_block, cfg, params, *args, sctx,
                              use_reentrant=False)
        else:
            n, d = _xent_block(cfg, params, *args, sctx)
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
    loss = lm_loss(cfg, params, hidden, batch["targets"], batch["loss_mask"],
                   sctx=sctx)
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
                # rows [i*b, (i+1)*b): the reference's (microbatches, b)
                # reshape, also where the batch is a DTensor split on dim 0
                # (a reshape cannot split it)
                mbatch = {k: v.narrow(0, i * (v.shape[0] // microbatches),
                                      v.shape[0] // microbatches)
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


def auto_microbatches(cfg, shape, n_batch_shards: int,
                      target_bytes: float = 4e9) -> int:
    """The gradient-accumulation depth at which the layer-boundary
    checkpoints fit, as the reference picks it: carry bytes = local batch
    x seq x d_model x 2 (bf16) x layer groups, halved by each doubling of
    the depth while it divides the local batch."""
    if shape.kind != "train":
        return 1
    local_b = max(1, shape.global_batch // max(1, n_batch_shards))
    groups = cfg.num_layers // transformer.program_period(cfg)
    carry = local_b * shape.seq_len * cfg.d_model * 2 * groups
    need = max(1, int(-(-carry // target_bytes)))
    mu = 1
    while mu < need and mu < local_b and local_b % (mu * 2) == 0:
        mu *= 2
    return mu


# ------------------------------ input specs ----------------------------- #

def input_specs(cfg, shape):
    """Every model input of a cell as ``meta`` tensors: for train and
    prefill the batch, for decode {token, cache, pos}.  A ``vision_stub``
    frontend adds its precomputed patch embeddings; decode's ``pos`` is a
    Python int, the cache's last slot (``seq_len - 1``), where the
    reference has an int32 scalar of no value."""
    B, S = shape.global_batch, shape.seq_len
    mk = lambda shape_, dt: torch.empty(shape_, dtype=dt, device="meta")
    nfe = cfg.frontend_tokens if cfg.frontend == "vision_stub" else 0
    s_text = S - nfe
    if shape.kind in ("train", "prefill"):
        spec = {"tokens": mk((B, s_text), torch.int32)}
        if nfe:
            spec["patches"] = mk((B, nfe, cfg.d_model), torch_dtype(cfg.dtype))
        if shape.kind == "train":
            spec["targets"] = mk((B, s_text), torch.int32)
            spec["loss_mask"] = mk((B, s_text), torch.float32)
        return spec
    return {"token": mk((B, 1), torch.int32),
            "cache": transformer.cache_specs(cfg, B, S, cfg.dtype),
            "pos": S - 1}


def input_axes(cfg, shape):
    """Logical sharding axes matching :func:`input_specs` (decode's cache
    one entry per layer, as ``transformer.cache_axes``)."""
    if shape.kind in ("train", "prefill"):
        ax = {"tokens": ("batch", "seq")}
        if cfg.frontend == "vision_stub":
            ax["patches"] = ("batch", "seq", None)
        if shape.kind == "train":
            ax["targets"] = ("batch", "seq")
            ax["loss_mask"] = ("batch", "seq")
        return ax
    return {"token": ("batch", None), "cache": transformer.cache_axes(cfg),
            "pos": ()}
