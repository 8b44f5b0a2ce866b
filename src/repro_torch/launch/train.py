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
that segment fails and is retried on the slots left.

Sharding: with ``--data-shards`` x ``--model-shards`` = N > 1 the driver
starts a pilot world of N ranks from its own process
(``PilotDescription(ranks=N)``: gloo, the ranks sharing the card with
``--device cuda``), and the whole run is tasks on it, as the paper's
training job is SPMD tasks on the pilot's MPI world.  An init task builds
the params and AdamW moments in the ranks (the same seeded values, placed
by ``param_pspecs`` on the block's (data, model) ``DeviceMesh``) or reads
the newest checkpoint onto their shards; the driver holds them only as
``RankRef``s, which every ``train_segment`` takes and returns.  Only
batches (numpy, each rank takes its rows), scalars and metrics cross.
Where a checkpoint or an evaluation falls, the segment's ranks keep a
clone of the state at that step beside it, which those tasks read (and
the last of them frees): AdamW changes the live tensors in place.  A
checkpoint is gathered in the ranks and written by the block's first rank
in the unsharded format, so the two paths restore each other's.  The
fault drill kills ``--inject-failure`` ranks of the running segment: the
world restarts, its ``RankRef``s go stale, and the driver rebuilds the
state on the new world from the newest checkpoint (or the seed) and runs
the steps since then again (``record["recomputed"]``).

Example (CPU, reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --reduced --steps 20 --segment 5 --batch 4 --seq 64 --device cpu \\
      --ckpt-dir build/ck --ckpt-every 10 --eval-every 20
  PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
      --data-shards 2 --model-shards 2 --device cpu --steps 10 \\
      --segment 5 --batch 4 --seq 32 --ckpt-dir build/ck2
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import time
from pathlib import Path

import numpy as np
import torch

from .. import params as P
from ..checkpoint.checkpoint import Checkpointer
from ..configs import get_config, reduce_config
from ..core import (DataFlowKernel, PilotDescription, RPEXExecutor,
                    StaleRankRef, TaskState, WorkerDied, python_app, spmd_app)
from ..data.pipeline import DataConfig, ShardedLoader
from ..device import resolve_device
from ..kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
from ..kernels.ssd import ssd_chunk_bwd_kernel, ssd_chunk_kernel
from ..kernels.ssd_pass import ssd_pass_bwd_kernel, ssd_pass_kernel
from ..models import model as M
from ..models import transformer as T
from ..optim import AdamState, AdamW, cosine_schedule
from ..sharding.partition import NULL_CTX, ShardCtx, spec_axes
from ..tree import flatten, tree_map

CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "ckpt"


def make_optimizer():
    return AdamW(lr=cosine_schedule(3e-4, 20, 10_000))


def build_state(cfg, device, seed=0, sctx=NULL_CTX):
    """Params, optimizer and its state; under a mesh the params (the same
    seeded values on every rank) become DTensors placed by
    ``param_pspecs``, and the moments take their placements."""
    params = T.init_params(cfg, seed, device=device)
    if sctx.mesh is not None:
        params = P.shard_tree(params, cfg, sctx.mesh, sctx.rules)
    opt = make_optimizer()
    return params, opt, opt.init(params)


def batch_shard(sctx, batch_rows):
    """(index, count) of this rank's block of the batch's rows: the batch
    rule's mesh axes, or the whole batch where it resolves to none."""
    if sctx.mesh is None:
        return 0, 1
    spec = sctx.spec(("batch",), (batch_rows,))
    i, n = 0, 1
    for a in spec_axes(spec[0] if spec else None):
        i = i * sctx.mesh[a].size() + sctx.mesh.get_local_rank(a)
        n *= sctx.mesh[a].size()
    return i, n


def checkpoint_tree(cfg, params, opt_state, cursor):
    """What a checkpoint holds, in the reference's layout and leaf order:
    (params, AdamState(step, m, v), cursor), layers stacked."""
    return (P.stack_layers(params, cfg),
            AdamState(opt_state.step, P.stack_layers(opt_state.m, cfg),
                      P.stack_layers(opt_state.v, cfg)),
            np.int64(cursor))


def restore_state(checkpointer, cfg, params, opt_state, step=None):
    """The newest checkpoint (or that of ``step``) read onto the structure
    (and, for DTensors, the shards) of ``params`` and ``opt_state``:
    (step, params, opt_state, data cursor)."""
    step, (sp, so, cursor) = checkpointer.restore(
        checkpoint_tree(cfg, params, opt_state, 0), step)
    return (step, P.unstack_layers(sp),
            AdamState(so.step, P.unstack_layers(so.m), P.unstack_layers(so.v)),
            int(cursor))


def state_drift(cfg, ck_dir, ref_dir, step, device="cpu"):
    """How far one run's checkpoint at ``step`` lies from another's
    (``ref_dir``), normwise in f32: the params' distance over the reference
    run's change from the seeded init, and each AdamW moment's distance
    over the reference's moment (a dropped update, a gradient over the
    wrong rows or a stale state moves them far more than the losses).
    {"params"|"m"|"v": {"all": over the whole tree, "worst": (the largest
    ratio of one leaf, its index), "leaves": each leaf's ratio},
    "steps": the AdamW step of each}; a leaf that the reference left as it
    was counts as infinitely far unless the other left it too.  ``device``
    is where both runs drew their init (a generator draws per device)."""
    params, _, opt_state = build_state(cfg, device)
    init = [t.float() for t in flatten(params)[0]]
    run, ref = (restore_state(Checkpointer(d), cfg, params, opt_state, step)
                for d in (ck_dir, ref_dir))

    def ratios(pairs):
        diffs, scales = [], []
        for a, b, base in pairs:
            diffs.append(float((a.float() - b.float()).norm()))
            scales.append(float((b.float() - base).norm()))
        each = [d / s if s else (0.0 if d == 0 else float("inf"))
                for d, s in zip(diffs, scales)]
        i = int(np.argmax(each))
        return {"all": float(np.linalg.norm(diffs) / np.linalg.norm(scales)),
                "worst": (each[i], i), "leaves": each}

    out = {"steps": (int(run[2].step), int(ref[2].step)),
           "params": ratios(zip(flatten(run[1])[0], flatten(ref[1])[0],
                                init))}
    for k in ("m", "v"):
        out[k] = ratios((a, b, 0.0) for a, b in zip(
            flatten(getattr(run[2], k))[0], flatten(getattr(ref[2], k))[0]))
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config's depth to this many layers (0: "
                         "as the config has it)")
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
    """The launch count of each kernel wrapper (K1, K1b, K2, K2b, K3,
    K3b)."""
    return {fn.__name__: fn.launches
            for fn in (flash_attention_fwd, flash_attention_bwd,
                       ssd_chunk_kernel, ssd_chunk_bwd_kernel,
                       ssd_pass_kernel, ssd_pass_bwd_kernel)}


def host_copy(tree):
    """A copy of ``tree`` on the host, as the reference's ``np.asarray``
    snapshot: untouched by later in-place updates."""
    return tree_map(lambda t: t.to("cpu", copy=True), tree)


def data_config(cfg, args):
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch,
                      frontend_tokens=cfg.frontend_tokens if
                      cfg.frontend == "vision_stub" else 0,
                      d_model=cfg.d_model)


def main(argv=None, record=None):
    """Run the driver; returns the loss of each segment.  ``record``, a
    dict, receives what the run measured: ``segments`` (per segment its
    task uid, each attempt's steps, body seconds and kernel launches read
    inside the body, and the device's peak after it), the failure drill's
    ``victims`` and the pilot's ``events``; on a world also the steps the
    drill ``recomputed``, the steps the state was ``rebuilt_at``, and the
    world's ``world_stats`` and ``world_calls``."""
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    device = resolve_device(args.device)
    record = {} if record is None else record
    if min(args.data_shards, args.model_shards) < 1:
        raise ValueError("--data-shards and --model-shards take at least "
                         "one rank each")
    if args.data_shards * args.model_shards > 1:
        return main_on_world(args, cfg, device, record)

    params, opt, opt_state = build_state(cfg, device)
    checkpointer = Checkpointer(args.ckpt_dir)
    loader_cursor = 0
    start_step = 0
    if args.resume and checkpointer.latest_step() is not None:
        start_step, params, opt_state, loader_cursor = restore_state(
            checkpointer, cfg, params, opt_state)
        print(f"[train] resumed from step {start_step} "
              f"(data cursor {loader_cursor})")

    loader = ShardedLoader(data_config(cfg, args), start_cursor=loader_cursor)
    step_fn = M.make_train_step(cfg, opt, microbatches=args.microbatches)

    def to_device(batch, dev):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    n_slots = args.slots or 4            # the pilot's slots over the device
    seg_slots = max(1, n_slots - 2)      # leave slots for eval/ckpt helpers
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
                print_step(step, loss, t0, peak)
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
    print_done(losses, step)
    return losses


def print_step(step, loss, t0, peak):
    print(f"[train] step {step:5d} loss {loss:.4f} "
          f"({(time.time()-t0):.1f}s"
          + (f", peak {peak / 2**30:.3f} GiB)" if peak else ")"),
          flush=True)


def print_done(losses, step):
    if losses:
        print(f"[train] done: {step} steps, final loss {losses[-1]:.4f}, "
              f"first loss {losses[0]:.4f}")
    else:
        # resumed past --steps: every segment was skipped via checkpoint
        print(f"[train] done: already at step {step}, nothing to run")


def inject_into(rpex, fut, n):
    """The fault drill: fail ``n`` slots of the running task of ``fut``,
    once it holds them.  Returns the uids of the tasks that were running
    there (they fail and retry on the slots left)."""
    task = wait_running(fut)
    return rpex.pilot.agent.inject_slot_failure(list(task.slot_ids[:n]))


def wait_running(fut):
    """The task of ``fut`` once it runs on its slots (or has ended)."""
    task = fut.task
    while not fut.done() and not (task.state == TaskState.RUNNING
                                  and task.slot_ids):
        time.sleep(0.001)
        task = fut.task
    return task


# ------------------------- the driver on a world ------------------------- #
# The bodies below run in the ranks of the pilot's world.  What a rank
# keeps between the tasks of a run (the block's step function, the
# snapshots the driver asked for) lives in the block's ``mesh.state``.  The
# state's DTensors lie on the block's groups, so the run needs the ranks to
# keep those groups from task to task: the executor's cache, which
# ``main_on_world`` turns on.
WORLD_FAULTS = (WorkerDied, StaleRankRef)      # a rank died: the world
                                                # restarts without the state


def _rank_step(mesh, cfg, microbatches):
    """(ShardCtx, optimizer, train step) on this rank's block, built once
    per block and config."""
    key = ("step", cfg, microbatches)
    if key not in mesh.state:
        sctx = ShardCtx(mesh.device_mesh)
        opt = make_optimizer()
        mesh.state[key] = (sctx, opt, M.make_train_step(
            cfg, opt, sctx, microbatches=microbatches))
    elif mesh.state[key][0].mesh is not mesh.device_mesh:
        raise RuntimeError("this task's block has new process groups, and "
                           "the training state lies on the old ones: the "
                           "driver on a world needs the executor's cache")
    return mesh.state[key]


def _rank_batch(sctx, batch, rows, device):
    """This rank's rows of a global batch (numpy) as DTensors of the
    global batch on the block's mesh."""
    from torch.distributed.tensor import DTensor
    i, n = batch_shard(sctx, rows)
    per = rows // n
    placements = sctx.placements(("batch",), (rows,))
    return {k: DTensor.from_local(
        torch.from_numpy(np.ascontiguousarray(v[i * per:(i + 1) * per]))
        .to(device), sctx.mesh, placements, run_check=False)
        for k, v in batch.items()}


def world_init(mesh, cfg, microbatches, ckpt_dir, resume):
    """The training state on this rank: the seeded params placed by
    ``param_pspecs`` on the block's mesh and their AdamW moments, or the
    newest checkpoint read onto those shards.  (params, opt_state, step,
    data cursor); the state stays on the ranks."""
    sctx, _, _ = _rank_step(mesh, cfg, microbatches)
    params, _, opt_state = build_state(cfg, mesh.device, sctx=sctx)
    step, cursor = 0, 0
    checkpointer = Checkpointer(ckpt_dir)
    if resume and checkpointer.latest_step() is not None:
        step, params, opt_state, cursor = restore_state(
            checkpointer, cfg, params, opt_state)
    mesh.state["snapshots"] = {}
    return params, opt_state, step, cursor


def world_segment(mesh, cfg, microbatches, rows, params, opt_state,
                  batches, snapshot):
    """``len(batches)`` steps on this rank's block.  With ``snapshot`` =
    (step, readers) the rank keeps a clone of the state it ends with, for
    that many checkpoint and evaluation tasks.  (params, opt_state,
    metrics, each rank's seconds, launches, device peak and snapshots
    held)."""
    import torch.distributed as dist
    sctx, _, step_fn = _rank_step(mesh, cfg, microbatches)
    t0 = time.perf_counter()
    before = kernel_launches()
    metrics = None
    for b in batches:
        params, opt_state, metrics = step_fn(
            params, opt_state, _rank_batch(sctx, b, rows, mesh.device))
    if snapshot is not None:
        state = tree_map(lambda t: t.clone(), (params, opt_state))
        mesh.state["snapshots"][snapshot[0]] = [state, snapshot[1]]
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    after = kernel_launches()
    mine = {"rank": mesh.rank, "seconds": time.perf_counter() - t0,
            "launches": {k: after[k] - before[k] for k in after},
            "peak_bytes": (torch.cuda.max_memory_allocated(mesh.device)
                           if mesh.device.type == "cuda" else None),
            "snapshots": len(mesh.state["snapshots"])}
    ranks = [None] * mesh.size
    dist.all_gather_object(ranks, mine, group=mesh.group())
    metrics = {k: float(M.full(v)) for k, v in metrics.items()}
    return params, opt_state, metrics, ranks


def _read_snapshot(mesh, step):
    """The state a segment kept at ``step``, freed after its last reader."""
    held = mesh.state["snapshots"][step]
    held[1] -= 1
    if held[1] == 0:
        del mesh.state["snapshots"][step]
    return held[0]


def world_commit(mesh, cfg, ckpt_dir, step, cursor):
    """Checkpoint the state kept at ``step``: the ranks gather it, the
    block's first rank writes it in the unsharded format."""
    params, opt_state = _read_snapshot(mesh, step)
    Checkpointer(ckpt_dir).save(step, checkpoint_tree(cfg, params, opt_state,
                                                      cursor),
                                group=mesh.group())
    return step


def world_evaluate(mesh, cfg, microbatches, rows, step, batch):
    """The loss of the params kept at ``step`` on ``batch``."""
    sctx, _, _ = _rank_step(mesh, cfg, microbatches)
    params, _ = _read_snapshot(mesh, step)
    with torch.no_grad(), M.on_mesh(sctx):
        loss, _ = M.loss_fn(cfg, params,
                            _rank_batch(sctx, batch, rows, mesh.device), sctx)
    return float(M.full(loss))


def main_on_world(args, cfg, device, record):
    """The driver with ``--data-shards`` x ``--model-shards`` = N > 1: a
    pilot world of N ranks and N + 2 slots (the reference's two helper
    slots; ``--slots`` sets them), every task an spmd task on the N ranks
    as a (data, model) block."""
    shape = (args.data_shards, args.model_shards)
    n = shape[0] * shape[1]
    n_slots = args.slots or n + 2
    if n_slots < n:
        raise ValueError(f"--data-shards {shape[0]} x --model-shards "
                         f"{shape[1]} needs {n} slots, --slots gives "
                         f"{n_slots}")
    on_block = spmd_app(slots=n, mesh=shape, jit=False)
    init, segment, commit, evaluate = map(on_block, (
        world_init, world_segment, world_commit, world_evaluate))
    rows = args.batch
    record.update(segments=[], victims=[], recomputed=0, rebuilt_at=[])
    rpex = RPEXExecutor(PilotDescription(n_slots=n_slots, devices=[device],
                                         ranks=n, cache_executables=True))
    world = rpex.pilot.world
    t0 = time.time()
    losses, ends = [], []               # each segment's loss and last step
    loader = None
    try:
        with DataFlowKernel(executors={"rpex": rpex}, run_id=None):
            params, opt_state, step, cursor = init(
                cfg, args.microbatches, args.ckpt_dir, args.resume).result()
            if step:
                print(f"[train] resumed from step {step} "
                      f"(data cursor {cursor})")
            loader = ShardedLoader(data_config(cfg, args), start_cursor=cursor)
            pending = []
            failed_injected = False
            failed_at = None            # the segment that failed last
            while step < args.steps:
                n_steps = min(args.segment, args.steps - step)
                end = step + n_steps
                ckpt_here = end % args.ckpt_every == 0 or end >= args.steps
                eval_here = end % args.eval_every == 0
                readers = ckpt_here + eval_here
                batches = [next(loader) for _ in range(n_steps)]
                fut = segment(cfg, args.microbatches, rows, params,
                              opt_state, batches,
                              (end, readers) if readers else None)
                try:
                    if (args.inject_failure and not failed_injected
                            and end >= args.steps // 2):
                        failed_injected = True
                        killed = kill_ranks(world, fut, args.inject_failure)
                        record["victims"].append(fut.task.uid)
                        print(f"[train] injected failure: killed ranks "
                              f"{killed} of the running segment")
                    params, opt_state, metrics, ranks = fut.result()
                except WORLD_FAULTS as e:
                    # the world restarted: rebuild the state on it from the
                    # newest checkpoint, and run the steps since again; a
                    # segment that fails twice in a row fails the run
                    if failed_at == end:
                        raise
                    failed_at = end
                    for f in pending:
                        err = f.exception()
                        if err is not None and not isinstance(err,
                                                              WORLD_FAULTS):
                            raise err
                    pending = []
                    params, opt_state, back, cursor = init(
                        cfg, args.microbatches, args.ckpt_dir,
                        args.resume).result()
                    record["recomputed"] += end - back
                    record["rebuilt_at"].append(back)
                    kept = sum(1 for x in ends if x <= back)
                    del losses[kept:], ends[kept:]
                    print(f"[train] segment to step {end} failed "
                          f"({type(e).__name__}); the state is rebuilt at "
                          f"step {back} on the restarted world")
                    step = back
                    loader.close()
                    loader = ShardedLoader(data_config(cfg, args),
                                           start_cursor=cursor)
                    continue
                step = end
                loss = metrics["loss"]
                losses.append(loss)
                ends.append(end)
                peaks = [r["peak_bytes"] for r in ranks]
                record["segments"].append({
                    "uid": fut.task.uid, "peak_bytes": peaks,
                    "attempts": [{"steps_run": n_steps,
                                  "seconds": max(r["seconds"] for r in ranks),
                                  "launches": ranks[0]["launches"],
                                  "ranks": ranks}]})
                print_step(step, loss, t0, max(peaks) if peaks[0] else None)
                # they read the segment's snapshot, so the ranks may take
                # them before or after the next segment: nothing waits here
                if ckpt_here:
                    pending.append(commit(cfg, args.ckpt_dir, step,
                                          loader.cursor))
                if eval_here:
                    pending.append(evaluate(cfg, args.microbatches, rows,
                                            step, next(loader)))
            for f in pending:
                f.result()
        record["events"] = rpex.pilot.store.events_snapshot()
        record["world_stats"] = dict(world.stats)
        record["world_calls"] = list(world.calls)
    finally:
        if loader is not None:
            loader.close()
        rpex.shutdown()
    print_done(losses, step)
    return losses


def kill_ranks(world, fut, n):
    """The fault drill on a world: SIGKILL the first ``n`` ranks of the
    running task of ``fut``, once it runs.  Returns their ranks."""
    task = wait_running(fut)
    ranks = sorted({s % world.n for s in task.slot_ids})[:n]
    pids = world.pids()
    for r in ranks:
        os.kill(pids[r], signal.SIGKILL)
    return ranks


if __name__ == "__main__":
    main()
