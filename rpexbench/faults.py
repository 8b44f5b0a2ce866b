"""Faults planted in the program under the timed path, for the tests and
the chip readings that show the check catches them: each a context
manager that patches one of the port's functions and restores it.

``unchanged``: AdamW's step returns the state it was given.
``half_batch``: the loss is taken over the first half of the batch's rows
(the mean over them); the prefill runs the first half of the rows and
returns their logits for both halves.
``answer``: the answer is altered where the program produces it: the
held-out loss of an evaluation (computed without grad) scaled by
1 + 1e-3, and row 0 of the prefill's last-token logits rolled by one
vocabulary position.
"""
from __future__ import annotations

import contextlib

import torch

KINDS = ("unchanged", "half_batch", "answer")


@contextlib.contextmanager
def planted(kind):
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    if kind is None:
        yield
        return
    if kind not in KINDS:
        raise ValueError(f"fault {kind!r}; known: {KINDS}")
    saved = (adamw.AdamW.update, M.loss_fn, M.make_prefill_step)
    loss_fn, make_prefill = M.loss_fn, M.make_prefill_step

    def unchanged(self, params, grads, state):
        return params, state, torch.zeros(())

    def half_batch(cfg, params, batch, *a, **kw):
        rows = batch["tokens"].shape[0] // 2
        return loss_fn(cfg, params, {k: v[:rows] for k, v in batch.items()},
                       *a, **kw)

    def answer_loss(cfg, params, batch, *a, **kw):
        loss, met = loss_fn(cfg, params, batch, *a, **kw)
        if not torch.is_grad_enabled():
            loss = loss * (1 + 1e-3)
        return loss, met

    def half_prefill(cfg, *a, **kw):
        step = make_prefill(cfg, *a, **kw)

        def halved(params, batch):
            rows = batch["tokens"].shape[0] // 2
            logits, cache = step(params, {k: v[:rows]
                                          for k, v in batch.items()})
            return torch.cat([logits, logits]), cache
        return halved

    def answer_prefill(cfg, *a, **kw):
        step = make_prefill(cfg, *a, **kw)

        def altered(params, batch):
            logits, cache = step(params, batch)
            logits[0] = logits[0].roll(1, dims=-1)
            return logits, cache
        return altered

    try:
        if kind == "unchanged":
            adamw.AdamW.update = unchanged
        elif kind == "half_batch":
            M.loss_fn = half_batch
            M.make_prefill_step = half_prefill
        else:
            M.loss_fn = answer_loss
            M.make_prefill_step = answer_prefill
        yield
    finally:
        adamw.AdamW.update, M.loss_fn, M.make_prefill_step = saved
