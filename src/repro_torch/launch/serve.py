"""Batched serving driver: decode with continuous batching.

Port of ``repro.launch.serve``, with the same loop and outputs.  Requests
arrive with different prompt lengths and generation budgets; the server
packs them into a fixed-slot decode batch (a slot frees as soon as its
sequence finishes and is refilled from the queue).  Prompts are fed token
by token through the decode step ("prefill-as-decode"), so every step has
one (B, 1) shape.

Example (CPU, reduced config):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --reduced --requests 12 --batch-slots 4 --max-new 16 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, reduce_config
from ..device import resolve_device
from ..models import model as M
from ..models import transformer as T


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-ctx", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    params = T.init_params(cfg, args.seed, device=resolve_device(args.device))
    return run(cfg, params, args)


def run(cfg, params, args):
    """Serve ``args.requests`` generated requests with ``params``.

    Returns {request id: generated tokens}.  Requests come from
    ``np.random.default_rng(args.seed)`` exactly as in the reference.
    """
    device = params["embed"].device
    rng = np.random.default_rng(args.seed)
    B = args.batch_slots
    decode = M.make_decode_step(cfg)

    # request queue: (prompt tokens, n_new)
    reqs = [(rng.integers(2, cfg.vocab_size,
                          size=rng.integers(4, args.max_ctx // 2)),
             int(rng.integers(2, args.max_new))) for _ in range(args.requests)]

    cache = T.init_cache(cfg, B, args.max_ctx, cfg.dtype, device=device)
    active = [None] * B            # [req_id, pos, n_new, prompt, gen] per slot
    outputs = {i: [] for i in range(len(reqs))}
    queue = list(enumerate(reqs))
    cur_tok = np.zeros((B, 1), np.int64)

    t0 = time.time()
    steps = 0
    while queue or any(a is not None for a in active):
        for s in range(B):
            if active[s] is None and queue:
                rid, (prompt, n_new) = queue.pop(0)
                active[s] = [rid, 0, n_new, list(prompt), []]
        for s in range(B):
            if active[s] is None:
                cur_tok[s, 0] = 0
                continue
            rid, pos, n_new, prompt, gen = active[s]
            cur_tok[s, 0] = (prompt[pos] if pos < len(prompt)
                             else (gen[-1] if gen else 1))
        # one decode step for the batch, at the smallest active position:
        # the reference's lockstep (see ROADMAP queue 3), kept as it is
        pos_scalar = int(min([a[1] for a in active if a is not None] or [0]))
        logits, cache = decode(params, torch.from_numpy(cur_tok).to(device),
                               cache, pos_scalar)
        steps += 1
        nxt = logits[:, 0].argmax(dim=-1).cpu().numpy()
        for s in range(B):
            if active[s] is None:
                continue
            a = active[s]
            a[1] += 1
            if a[1] >= len(a[3]):                 # past prefill: generating
                a[4].append(int(nxt[s]))
            if len(a[4]) >= a[2] or a[1] >= args.max_ctx - 1:
                outputs[a[0]] = a[4]
                active[s] = None                  # slot freed -> refilled
    dt = time.time() - t0
    done = sum(1 for v in outputs.values() if v is not None)
    print(f"[serve] {done}/{len(reqs)} requests, {steps} decode steps, "
          f"{steps*B/dt:.1f} tok-slots/s, {dt:.1f}s on {device}")
    for i in sorted(outputs)[:4]:
        print(f"  req {i}: {outputs[i][:8]}")
    return outputs


if __name__ == "__main__":
    main()
