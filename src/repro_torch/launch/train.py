"""End-to-end training driver.

Port of ``repro.launch.train``: the same command line, prints, and segment,
evaluate, checkpoint and resume logic, plus ``--device`` (``cuda`` unless
told otherwise; without a card it raises rather than fall back to the CPU).
In the reference the job is an RPEX workflow: the device pilot runs
``train_segment`` SPMD tasks (N optimizer steps each) while single-slot
Python tasks run ``evaluate`` and ``commit_checkpoint``.  The runtime
(``repro.core``) is not ported yet (ROADMAP queue 1 item 7), so here the
three are plain functions called in the reference's order in one process;
they become pilot tasks when the runtime lands.  ``--slots`` and
``--inject-failure`` (which need the pilot) and ``--data-shards`` x
``--model-shards`` > 1 (sharding, ROADMAP queue 1 item 13) raise.

Auto-resume from the newest checkpoint (params, optimizer state, data
cursor), written in the reference's on-disk format: either package resumes
from the other's checkpoints.

Example (CPU, reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --reduced --steps 20 --segment 5 --batch 4 --seq 64 --device cpu \\
      --ckpt-dir build/ck --ckpt-every 10 --eval-every 20
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from .. import params as P
from ..checkpoint.checkpoint import Checkpointer
from ..configs import get_config, reduce_config
from ..data.pipeline import DataConfig, ShardedLoader
from ..device import resolve_device
from ..models import model as M
from ..models import transformer as T
from ..optim import AdamState, AdamW, cosine_schedule

CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "ckpt"


def build_state(cfg, device, seed=0):
    params = T.init_params(cfg, seed, device=device)
    opt = AdamW(lr=cosine_schedule(3e-4, 20, 10_000))
    return params, opt, opt.init(params)


def checkpoint_tree(cfg, params, opt_state, cursor):
    """What a checkpoint holds, in the reference's layout and leaf order:
    (params, AdamState(step, m, v), cursor), layers stacked."""
    return (P.stack_layers(params, cfg),
            AdamState(opt_state.step, P.stack_layers(opt_state.m, cfg),
                      P.stack_layers(opt_state.v, cfg)),
            np.int64(cursor))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--segment", type=int, default=10,
                    help="steps per train_segment task")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR),
                    help="checkpoints, resumed from at start (default: "
                         "build/ckpt in the checkout)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--slots", type=int, default=0)
    ap.add_argument("--data-shards", type=int, default=1)
    ap.add_argument("--model-shards", type=int, default=1)
    ap.add_argument("--inject-failure", type=int, default=0,
                    help="kill this many slots mid-run (fault drill)")
    ap.add_argument("--resume", action="store_true", default=True)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.slots:
        raise NotImplementedError(
            "--slots: the pilot runtime is not ported yet (ROADMAP queue 1 "
            "item 7)")
    if args.inject_failure:
        raise NotImplementedError(
            "--inject-failure: slot failures need the pilot runtime, not "
            "ported yet (ROADMAP queue 1 item 7)")
    if args.data_shards * args.model_shards > 1:
        raise NotImplementedError(
            "--data-shards x --model-shards > 1: sharding is not ported yet "
            "(ROADMAP queue 1 item 13)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    device = resolve_device(args.device)

    params, opt, opt_state = build_state(cfg, device)
    ckpt = Checkpointer(args.ckpt_dir)
    loader_cursor = 0
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        start_step, (sp, so, cursor_arr) = ckpt.restore(
            checkpoint_tree(cfg, params, opt_state, 0))
        params = P.unstack_layers(sp)
        opt_state = AdamState(so.step, P.unstack_layers(so.m),
                              P.unstack_layers(so.v))
        loader_cursor = int(cursor_arr)
        print(f"[train] resumed from step {start_step} "
              f"(data cursor {loader_cursor})")

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch,
                      frontend_tokens=cfg.frontend_tokens if
                      cfg.frontend == "vision_stub" else 0,
                      d_model=cfg.d_model)
    loader = ShardedLoader(dcfg, start_cursor=loader_cursor)
    step_fn = M.make_train_step(cfg, opt, microbatches=args.microbatches)

    def to_device(batch):
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    def train_segment(params, opt_state, batches):
        metrics = None
        for b in batches:
            params, opt_state, metrics = step_fn(params, opt_state, b)
        return params, opt_state, metrics

    def evaluate(params, batch):
        with torch.no_grad():
            loss, _ = M.loss_fn(cfg, params, batch)
        return float(loss)

    def commit_checkpoint(step, params, opt_state, cursor):
        ckpt.save(step, checkpoint_tree(cfg, params, opt_state, cursor))
        return step

    t0 = time.time()
    losses = []
    try:
        step = start_step
        while step < args.steps:
            n = min(args.segment, args.steps - step)
            batches = [to_device(next(loader)) for _ in range(n)]
            params, opt_state, metrics = train_segment(params, opt_state,
                                                       batches)
            step += n
            loss = float(metrics["loss"])
            losses.append(loss)
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"({(time.time()-t0):.1f}s)", flush=True)
            if step % args.ckpt_every == 0 or step >= args.steps:
                commit_checkpoint(step, params, opt_state, loader.cursor)
            if step % args.eval_every == 0:
                evaluate(params, to_device(next(loader)))
    finally:
        loader.close()
    if losses:
        print(f"[train] done: {step} steps, final loss {losses[-1]:.4f}, "
              f"first loss {losses[0]:.4f}")
    else:
        # resumed past --steps: every segment was skipped via checkpoint
        print(f"[train] done: already at step {step}, nothing to run")
    return losses


if __name__ == "__main__":
    main()
