"""Multi-rank worlds on the CPU for the port's sharding tests.

``run_world`` spawns ``world`` processes joined in a gloo process group
through a ``FileStore`` under the caller's temporary directory (no TCP
port, so parallel test workers do not collide), runs ``target(rank,
world, *args)`` in each and returns what each rank returned.  A world that
does not end within ``timeout`` seconds is killed and fails the test.

Workers import ``torch`` and ``repro_torch`` only, never ``jax`` or the
reference package ``repro``: each checks so before it returns.  Values go
in and out as numpy arrays and plain Python objects.
"""
from __future__ import annotations

import os
import sys
import traceback

import torch
import torch.multiprocessing as mp


def _isolated():
    """Names of loaded modules this worker must not have."""
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.") or m == "repro"
                  or m.startswith("repro."))


def _entry(rank, world, store, out_dir, target, args):
    import torch.distributed as dist
    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}.pt")
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        result = target(rank, world, *args)
        bad = _isolated()
        if bad:
            raise AssertionError(f"a worker loaded {bad[:5]}")
        torch.save({"ok": True, "result": result}, path)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        torch.save({"ok": False, "error": traceback.format_exc()}, path)
        raise


def run_world(target, world, tmp_path, *args, timeout=120.0):
    """``target(rank, world, *args)`` on every rank of a gloo world of
    ``world`` processes; returns the ranks' results, rank 0 first."""
    out_dir = os.path.join(str(tmp_path), f"world{os.getpid()}_{id(args)}")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(r, world, store, out_dir, target, args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    import time
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    results = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.pt")
        got = (torch.load(path, weights_only=False) if os.path.exists(path)
               else None)
        if got is not None and not got["ok"]:
            raise AssertionError(f"rank {r} failed:\n{got['error']}")
        results.append(got)
    if hung:
        raise AssertionError(f"{len(hung)} of {world} ranks did not end "
                             f"within {timeout} s")
    if any(g is None for g in results):
        codes = [p.exitcode for p in procs]
        raise AssertionError(f"ranks ended without a result, exit codes "
                             f"{codes}")
    return [g["result"] for g in results]


# ------------------------------- workers -------------------------------- #

def _port_cfg(arch, over):
    import dataclasses
    from repro_torch import configs as TC
    return dataclasses.replace(TC.reduce_config(TC.get_config(arch)), **over)


def _ctx(dims):
    """A ShardCtx on a CPU mesh of ``dims`` ({name: size}, in order)."""
    from repro_torch.launch.mesh import _mesh
    from repro_torch.sharding import ShardCtx
    return ShardCtx(_mesh(tuple(dims.values()), tuple(dims), "cpu"))


def model_loss_and_grads(rank, world, arch, over, dims, tree, batch,
                         microbatches=0):
    """The sharded port's loss, aux and gathered grads (rank 0 returns
    them) for the reference's numpy params ``tree`` and ``batch``; with
    ``microbatches`` a train step with AdamW instead, returning its
    metrics and the updated params."""
    from repro_torch import params as P
    from repro_torch.models import model as M
    cfg = _port_cfg(arch, over)
    sctx = _ctx(dims)
    params = P.shard_tree(P.from_numpy_tree(tree, device="cpu"), cfg,
                          sctx.mesh)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if microbatches:
        from repro_torch.optim import AdamW
        opt = AdamW()
        step = M.make_train_step(cfg, opt, sctx, microbatches=microbatches)
        state = opt.init(params)
        params, state, metrics = step(params, state, tb)
        out = {"metrics": {k: float(v) for k, v in metrics.items()},
               "params": P.to_numpy_tree(P.gather_tree(params), cfg),
               "dtensor": _all_dtensors(params) and _all_dtensors(state.m)}
        return out if rank == 0 else None
    grads, metrics = M.make_loss_and_grad(cfg, sctx)(params, tb)
    out = {"loss": float(metrics["loss"]), "aux": float(metrics["aux"]),
           "dtensor": _all_dtensors(grads),
           "grads": P.to_numpy_tree(P.gather_tree(grads), cfg)}
    return out if rank == 0 else None


def _all_dtensors(tree):
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import leaves
    return all(isinstance(t, DTensor) for t in leaves(tree))


def _replicated(a, mesh, grad=False):
    """A numpy array -> a replicated DTensor on ``mesh``."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    t = distribute_tensor(torch.from_numpy(a), mesh,
                          [Replicate()] * mesh.ndim)
    return t.requires_grad_() if grad else t


def _full(t):
    return t.full_tensor().detach().numpy()


def attention_cases(rank, world, cases):
    """``sharded_flash_attention`` on each case: (dims, q, k, v, do,
    window, cap) -> (strategy, o, dq, dk, dv) as full arrays (rank 0)."""
    from repro_torch.models import attention as A
    out = []
    for dims, q, k, v, do, window, cap in cases:
        mesh = _ctx(dims).mesh
        qt, kt, vt = (_replicated(a, mesh, grad=True) for a in (q, k, v))
        strategy = A.attention_strategy(mesh, q.shape, k.shape[2])[0]
        from repro_torch.models.model import on_mesh
        from repro_torch.sharding import ShardCtx
        with on_mesh(ShardCtx(mesh)):
            o = A.sharded_flash_attention(mesh, qt, kt, vt, window=window,
                                          attn_softcap=cap)
            (o * _replicated(do, mesh)).sum().backward()
        out.append((strategy, _full(o), _full(qt.grad), _full(kt.grad),
                    _full(vt.grad)))
    return out if rank == 0 else None


def decode_cases(rank, world, cases):
    """``sharded_decode_attention`` with the cache placed by its logical
    axes: (dims, q, kc, vc, kx, vx, pos, window, cap) -> (the cache's
    spec, out, k cache, v cache) as full arrays (rank 0)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models import attention as A
    from repro_torch.sharding import ShardCtx
    from repro_torch.sharding.partition import placements_for
    out = []
    for dims, q, kc, vc, kx, vx, pos, window, cap in cases:
        sctx = _ctx(dims)
        spec = sctx.spec(("batch", "seq_kv", "kv_heads", "head_dim"),
                         kc.shape)
        pl = placements_for(spec, sctx.mesh)
        kct, vct = (distribute_tensor(torch.from_numpy(a.copy()), sctx.mesh,
                                      pl) for a in (kc, vc))
        args = [_replicated(a, sctx.mesh) for a in (q, kx, vx)]
        with torch.no_grad():
            o, k2, v2 = A.sharded_decode_attention(
                sctx.mesh, args[0], kct, vct, args[1], args[2], pos,
                window=window, attn_softcap=cap)
        assert k2 is kct and k2.placements == pl   # written in place
        out.append((spec, _full(o), _full(k2), _full(v2)))
    return out if rank == 0 else None


def ssd_case(rank, world, dims, x, dt, A_, B_, C_, dy, chunk):
    """``sharded_ssd``: y, the final state and the grads of (y * dy).sum()
    as full arrays, and the output's placements (rank 0)."""
    from repro_torch.models.mamba2 import sharded_ssd
    mesh = _ctx(dims).mesh
    ins = [_replicated(a, mesh, grad=True) for a in (x, dt, A_, B_, C_)]
    y, h = sharded_ssd(mesh, *ins, chunk)
    (y * _replicated(dy, mesh)).sum().backward()
    out = (str(y.placements), _full(y), _full(h),
           [_full(t.grad) for t in ins])
    return out if rank == 0 else None


def run_jobs(rank, world, jobs):
    """Several workers in one world, in order: {name: (fn, args)} ->
    {name: what fn returned}."""
    return {name: fn(rank, world, *args) for name, (fn, args) in jobs.items()}


def isolation_probe(rank, world):
    """A mesh, a tensor placed on it, and the modules this rank loaded that
    it must not have (none)."""
    from repro_torch.sharding import ShardCtx
    sctx = ShardCtx(_ctx({"data": 1, "model": world}).mesh)
    x = _replicated(torch.ones(world, 4).numpy(), sctx.mesh)
    assert sctx.act(x, (None, "heads")).to_local().shape == (world, 4 // world)
    return _isolated()
