#!/usr/bin/env python3
"""Which collectives gloo runs on CUDA tensors, for a pilot world whose
ranks share one card.

Starts a world of 2 gloo ranks on cuda:0 (``PilotDescription(ranks=2)``)
and runs each collective as a task of its own on both ranks, so that one
that crashes its rank (the world then restarts) does not hide the others:
the c10d calls (all_reduce, all_gather, all_gather_into_tensor,
reduce_scatter_tensor, all_to_all_single, broadcast), the functional ops
that DTensor calls (``torch.ops._c10d_functional`` all_reduce,
all_gather_into_tensor, reduce_scatter_tensor, each waited), and DTensor's
``full_tensor`` of a shard, which goes through the world's routing of
functional all-gathers (``spmd_world._gather_through_c10d``).  Prints one
line a collective, "ok" or what failed, and the card with its power limit.
Needs a CUDA card:
  PYTHONPATH=src python tools/gloo_cuda_collectives.py
"""
from __future__ import annotations

import subprocess
import sys

import torch

OPS = ("all_reduce", "all_gather", "all_gather_into_tensor",
       "reduce_scatter_tensor", "all_to_all_single", "broadcast",
       "functional all_reduce", "functional all_gather_into_tensor",
       "functional reduce_scatter_tensor", "DTensor full_tensor")


def one(mesh, name):
    """An spmd body: the collective ``name`` over the block, on CUDA."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    g, dev = mesh.group(), mesh.device
    x = torch.arange(8.0, device=dev) + mesh.rank
    fn = torch.ops._c10d_functional
    run = {
        "all_reduce": lambda: dist.all_reduce(x.clone(), group=g),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(2)], x, group=g),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            x.new_empty(16), x, group=g),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            x.new_empty(4), x, group=g),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x, group=g),
        "broadcast": lambda: dist.broadcast(x.clone(), src=mesh.ranks[0],
                                            group=g),
        "functional all_reduce": lambda: fn.wait_tensor(
            fn.all_reduce(x, "sum", g.group_name)),
        "functional all_gather_into_tensor": lambda: fn.wait_tensor(
            fn.all_gather_into_tensor(x, 2, g.group_name)),
        "functional reduce_scatter_tensor": lambda: fn.wait_tensor(
            fn.reduce_scatter_tensor(x, "sum", 2, g.group_name)),
        "DTensor full_tensor": lambda: distribute_tensor(
            x.reshape(2, 4), mesh.device_mesh,
            [Shard(0), Replicate()]).full_tensor(),
    }
    try:
        run[name]()
        torch.cuda.synchronize(dev)
        return "ok"
    except Exception as e:          # noqa: BLE001 — reported, per op
        return f"{type(e).__name__}: {str(e)[:160]}"


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from repro_torch.core import PilotDescription, RPEXExecutor
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    rpex = RPEXExecutor(PilotDescription(devices=[torch.device("cuda", 0)],
                                         ranks=2, n_slots=2))
    try:
        for name in OPS:
            try:
                got = rpex.pilot.world.run(one, (name,), {}, (0, 1), (2, 1))
            except Exception as e:  # noqa: BLE001 — a rank crashed
                got = f"{type(e).__name__}: {str(e)[:160]}"
            print(f"{name}: {got}", flush=True)
    finally:
        rpex.shutdown()


if __name__ == "__main__":
    main()
