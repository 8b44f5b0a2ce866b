"""End-to-end training driver, workflow-managed.

Port of ``repro.launch.train``: the same command line, prints, and segment,
evaluate, checkpoint and resume logic, plus ``--device`` (``cuda`` unless
told otherwise; without a card it raises rather than fall back to the CPU).
The training job is an RPEX workflow (the paper's model): the pilot holds
the device as its slots and runs ``train_segment`` SPMD tasks (N optimizer
steps each), while single-slot Python tasks handle evaluation and
checkpoint commits concurrently — the heterogeneous-task mix of the
Colmena use case, applied to an LM pre-training job.

The optimizer updates params and moments in place (the port's counterpart
of the reference's donated buffers), so each segment's result aliases the
live training state: the object store's hold on it costs no device
memory, and ``evaluate`` and ``commit_checkpoint`` take host copies made
before the next segment runs.  A segment is a checkpointable task that
saves its progress after every step (in memory): a retried segment
resumes from its last saved step instead of applying its steps twice.

Fault tolerance: auto-resume from the newest checkpoint (params, optimizer
state, data cursor), written in the reference's on-disk format (either
package resumes from the other's checkpoints); ``--inject-failure N``
fails N slots of the segment that crosses half the run while it runs, so
that segment fails and is retried on the slots left.  ``--data-shards`` x
``--model-shards`` > 1 (sharding, ROADMAP queue 1 item 13) raise.

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
from ..core import (DataFlowKernel, PilotDescription, RPEXExecutor, TaskState,
                    python_app, spmd_app)
from ..data.pipeline import DataConfig, ShardedLoader
from ..device import resolve_device
from ..kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
from ..kernels.ssd import ssd_chunk_bwd_kernel, ssd_chunk_kernel
from ..models import model as M
from ..models import transformer as T
from ..optim import AdamState, AdamW, cosine_schedule
from ..tree import tree_map

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


def kernel_launches():
    """The launch count of each kernel wrapper (K1, K1b, K2, K2b)."""
    return {fn.__name__: fn.launches
            for fn in (flash_attention_fwd, flash_attention_bwd,
                       ssd_chunk_kernel, ssd_chunk_bwd_kernel)}


def host_copy(tree):
    """A copy of ``tree`` on the host, as the reference's ``np.asarray``
    snapshot: untouched by later in-place updates."""
    return tree_map(lambda t: t.to("cpu", copy=True), tree)


def main(argv=None, record=None):
    """Run the driver; returns the loss of each segment.  ``record``, a
    dict, receives what the run measured: ``segments`` (per segment its
    task uid, each attempt's steps, body seconds and kernel launches read
    inside the body, and the device's peak after it), the failure drill's
    ``victims`` and the pilot's ``events``."""
    args = parse_args(argv)
    if args.data_shards * args.model_shards > 1:
        raise NotImplementedError(
            "--data-shards x --model-shards > 1: sharding is not ported yet "
            "(ROADMAP queue 1 item 13)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    device = resolve_device(args.device)

    params, opt, opt_state = build_state(cfg, device)
    checkpointer = Checkpointer(args.ckpt_dir)
    loader_cursor = 0
    start_step = 0
    if args.resume and checkpointer.latest_step() is not None:
        start_step, (sp, so, cursor_arr) = checkpointer.restore(
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

    def to_device(batch, dev):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    n_slots = args.slots or 4            # the pilot's slots over the device
    seg_slots = max(1, n_slots - 2)      # leave slots for eval/ckpt helpers
    record = {} if record is None else record
    record.update(segments=[], victims=[])
    attempts = []                        # bodies of the segment in flight

    @spmd_app(slots=seg_slots, jit=False, checkpointable=True, retries=1)
    def train_segment(mesh, params, opt_state, batches, ckpt):
        # the segment runs on its sub-mesh's device; batches arrive as host
        # arrays.  Resume from this task's last saved step (a retry)
        t0 = time.perf_counter()
        before = kernel_launches()
        done, metrics = 0, None
        saved = ckpt.restore()
        if saved is not None:
            done, (params, opt_state, metrics) = saved
        for i in range(done, len(batches)):
            params, opt_state, metrics = step_fn(
                params, opt_state, to_device(batches[i], mesh.device))
            ckpt.save(i + 1, (params, opt_state, metrics))
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        after = kernel_launches()
        attempts.append({"steps_run": len(batches) - done,
                         "seconds": time.perf_counter() - t0,
                         "launches": {k: after[k] - before[k]
                                      for k in after}})
        return params, opt_state, metrics

    @python_app
    def evaluate(params, batch):
        params = tree_map(lambda t: t.to(device), params)
        with torch.no_grad():
            loss, _ = M.loss_fn(cfg, params, to_device(batch, device))
        return float(loss)

    @python_app
    def commit_checkpoint(step, params, opt_state, cursor):
        checkpointer.save(step, checkpoint_tree(cfg, params, opt_state,
                                                cursor))
        return step

    rpex = RPEXExecutor(PilotDescription(n_slots=n_slots, devices=[device]))
    t0 = time.time()
    losses = []
    try:
        with DataFlowKernel(executors={"rpex": rpex}, run_id=None):
            step = start_step
            pending = []
            failed_injected = False
            while step < args.steps:
                n = min(args.segment, args.steps - step)
                batches = [next(loader) for _ in range(n)]
                fut = train_segment(params, opt_state, batches)
                if (args.inject_failure and not failed_injected
                        and step + n >= args.steps // 2):
                    failed_injected = True
                    victims = inject_into(rpex, fut, args.inject_failure)
                    record["victims"] += victims
                    print(f"[train] injected failure on "
                          f"{args.inject_failure} slots (victims: {victims})")
                params, opt_state, metrics = fut.result()
                step += n
                loss = float(metrics["loss"])
                losses.append(loss)
                # the device's peak so far: flat from segment to segment
                # unless something holds a state per segment
                peak = (torch.cuda.max_memory_allocated(device)
                        if device.type == "cuda" else None)
                record["segments"].append({"uid": fut.task.uid,
                                           "attempts": list(attempts),
                                           "peak_bytes": peak})
                attempts.clear()
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"({(time.time()-t0):.1f}s"
                      + (f", peak {peak / 2**30:.3f} GiB)" if peak else ")"),
                      flush=True)
                if step % args.ckpt_every == 0 or step >= args.steps or \
                        step % args.eval_every == 0:
                    # host snapshot BEFORE the next segment updates these
                    snap_p = host_copy(params)
                if step % args.ckpt_every == 0 or step >= args.steps:
                    pending.append(commit_checkpoint(step, snap_p,
                                                     host_copy(opt_state),
                                                     loader.cursor))
                if step % args.eval_every == 0:
                    pending.append(evaluate(snap_p, next(loader)))
            for f in pending:
                f.result()
        record["events"] = rpex.pilot.store.events_snapshot()
    finally:
        loader.close()
        rpex.shutdown()
    if losses:
        print(f"[train] done: {step} steps, final loss {losses[-1]:.4f}, "
              f"first loss {losses[0]:.4f}")
    else:
        # resumed past --steps: every segment was skipped via checkpoint
        print(f"[train] done: already at step {step}, nothing to run")
    return losses


def inject_into(rpex, fut, n):
    """The fault drill: fail ``n`` slots of the running task of ``fut``,
    once it holds them.  Returns the uids of the tasks that were running
    there (they fail and retry on the slots left)."""
    task = fut.task
    while not fut.done() and not (task.state == TaskState.RUNNING
                                  and task.slot_ids):
        time.sleep(0.001)
        task = fut.task
    return rpex.pilot.agent.inject_slot_failure(list(task.slot_ids[:n]))


if __name__ == "__main__":
    main()
