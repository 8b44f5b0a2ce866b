"""Dry-run: count every (arch x shape x mesh) cell on a fake world.

Port of ``repro.launch.dryrun``, which lowers and compiles each cell for
512 placeholder TPU devices and reads XLA's cost and memory analyses.
Here the cell runs: a ``torch.distributed`` world of 256 (``pod16x16``) or
512 (``pod2x16x16``) ranks on the ``fake`` backend, created only in this
module's own process (:func:`fake_world`), holds the mesh; the params,
optimizer state, inputs and caches are ``meta`` tensors (shape and dtype,
no storage) placed as DTensors by the partition rules; and the port's own
step functions run once on them under a
:class:`repro_torch.roofline.counter.StepCounter`, which counts what the
counted rank runs: FLOPs, bytes, collectives and peak live bytes.  The
kernels go through their ``meta`` routes and count by their own cost
formulas (``repro_torch.kernels.cost``).  No card is needed.

The counted rank is the world's last: under attention's ``seq`` strategy
the last model rank holds the last q chunk and does the most causal work;
elsewhere the ranks do the same work.

Each cell writes a JSON artifact with the reference's keys where they mean
the same (``status``, ``n_chips``, ``memory``, ``peak_bytes_per_device``,
``cost.flops_per_device``, ``cost.bytes_per_device``, ``collectives``,
``model_flops_global``, ``microbatches``, ``params``, ``active_params``,
``tokens``, ``roofline``); ``fits_80GB`` (an H100's memory) takes the place
of ``fits_16GB``, ``trace_s`` of ``lower_s``/``compile_s``, and
``hardware`` names the roofline's hardware model.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-done]
  python -m repro_torch.roofline.report --mesh pod16x16
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from ..configs import ARCHS, cells, get_config, get_shape
from ..models import model as M
from ..models import transformer as T
from ..optim import AdamState, AdamW
from ..params import shard_tree
from ..roofline.analysis import (collective_census, hardware_model,
                                 roofline_terms)
from ..roofline.counter import count
from ..sharding.partition import PartitionRules, ShardCtx, placements_for

ART_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
HBM_BYTES = 80e9           # an H100's memory


def _opt_for(cfg) -> AdamW:
    # >=100B params: bf16 moments, as the reference's rule
    big = cfg.param_count() >= 100e9
    return AdamW(state_dtype="bfloat16" if big else "float32")


def _grad_dtype_for(cfg) -> str:
    return "bfloat16" if cfg.param_count() >= 100e9 else "float32"


def fake_world(n: int, rank: int):
    """A process group of ``n`` ranks on the ``fake`` backend, this
    process rank ``rank``: collectives return at once and move nothing.
    An existing group of another size or rank is replaced."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_rank() == rank:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)


def mesh_for(multi_pod: bool = False, mesh_shape=None):
    """(mesh name, DeviceMesh) on a fake world of the mesh's size, the
    counted rank the last: ``pod16x16`` (data 16, model 16),
    ``pod2x16x16`` (pod 2, data 16, model 16) or a ``(data, model)``
    carve of the 256-rank pod."""
    from torch.distributed.device_mesh import init_device_mesh
    if mesh_shape:
        shape, names = tuple(mesh_shape), ("data", "model")
        name = f"pod{shape[0]}x{shape[1]}"
    elif multi_pod:
        shape, names = (2, 16, 16), ("pod", "data", "model")
        name = "pod2x16x16"
    else:
        shape, names, name = (16, 16), ("data", "model"), "pod16x16"
    n = 1
    for s in shape:
        n *= s
    fake_world(n, n - 1)
    return name, init_device_mesh("cpu", shape, mesh_dim_names=names)


def _place(tree, axes, mesh, rules):
    """Each meta tensor of ``tree`` as a DTensor placed by its logical
    axes in ``axes`` (a tree of the same structure); other leaves as they
    are."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, torch.Tensor):
        return distribute_tensor(tree, mesh, placements_for(
            rules.spec_for(axes, tree.shape, mesh), mesh))
    if isinstance(tree, dict):
        return {k: _place(v, axes[k], mesh, rules) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_place(v, a, mesh, rules) for v, a in zip(tree, axes)]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            type(tree)(items)
    return tree


def build_cell(arch: str, shape_name: str, mesh, rules=None,
               cfg_overrides=None, mu_override=None):
    """(cfg, shape, step, args): ``step(*args)`` runs the cell's step on
    its abstract params, state and inputs, placed on ``mesh``."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = get_shape(shape_name)
    rules = rules or PartitionRules()
    sctx = ShardCtx(mesh, rules)
    p_abs = T.abstract_params(cfg)
    params = shard_tree(p_abs, cfg, mesh, rules)
    inputs = _place(M.input_specs(cfg, shape), M.input_axes(cfg, shape),
                    mesh, rules)
    if shape.kind == "train":
        opt = _opt_for(cfg)
        o_abs = opt.abstract_state(p_abs)
        state = AdamState(o_abs.step, shard_tree(o_abs.m, cfg, mesh, rules),
                          shard_tree(o_abs.v, cfg, mesh, rules))
        bspec = rules.spec_for(("batch",), (shape.global_batch,), mesh)
        n_batch_shards = 1
        for entry in bspec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                n_batch_shards *= dict(zip(mesh.mesh_dim_names,
                                           mesh.mesh.shape))[a]
        mu = mu_override or M.auto_microbatches(cfg, shape, n_batch_shards)
        # microbatching must not shrink the global batch below the number
        # of batch shards, as the reference keeps it
        while mu > 1 and shape.global_batch // mu < n_batch_shards:
            mu //= 2
        step = M.make_train_step(cfg, opt, sctx, microbatches=mu,
                                 grad_dtype=_grad_dtype_for(cfg))
        step.microbatches = mu
        args = (params, state, inputs)
    elif shape.kind == "prefill":
        step = M.make_prefill_step(cfg, sctx)
        args = (params, inputs)
    else:
        step = M.make_decode_step(cfg, sctx)
        args = (params, inputs["token"], inputs["cache"], inputs["pos"])
    return cfg, shape, step, args


def count_cell(step, args):
    """Run ``step(*args)`` under a counter: (its totals, seconds)."""
    t0 = time.time()
    _, totals = count(step, *args)
    return totals, time.time() - t0


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             rules=None, cfg_overrides=None, tag: str = "", mu=None,
             mesh_shape=None):
    mesh_name, mesh = mesh_for(multi_pod, mesh_shape)
    suffix = f"__{tag}" if tag else ""
    out_path = out_dir / mesh_name / f"{arch}__{shape_name}{suffix}.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    cfg, shape, step, args = build_cell(
        arch, shape_name, mesh, rules=rules, cfg_overrides=cfg_overrides,
        mu_override=mu)
    build_s = time.time() - t0
    totals, trace_s = count_cell(step, args)
    peak = totals["peak_bytes"]
    training = shape.kind == "train"
    artifact = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
        "n_chips": int(mesh.size()), "counted_rank": int(mesh.size()) - 1,
        "kind": shape.kind, "status": "ok",
        "build_s": round(build_s, 1), "trace_s": round(trace_s, 1),
        "num_layers": cfg.num_layers,
        "memory": {"argument_size_in_bytes": totals["arg_bytes"],
                   "temp_size_in_bytes": peak - totals["arg_bytes"],
                   "peak_size_in_bytes": peak},
        "peak_bytes_per_device": peak,
        "fits_80GB": bool(peak < HBM_BYTES),
        "cost": {"flops_per_device": totals["flops"],
                 "bytes_per_device": totals["bytes"],
                 "bytes_by_scope": dict(sorted(
                     totals["by_name"].items(), key=lambda kv: -kv[1])[:60]),
                 "flops_by_scope": dict(sorted(
                     totals["flops_by_name"].items(),
                     key=lambda kv: -kv[1])[:20]),
                 "kernels": totals["kernels"]},
        "collectives": collective_census(totals["collectives"]),
        "model_flops_global": cfg.model_flops_per_token(training)
        * shape.tokens,
        "microbatches": getattr(step, "microbatches", 1),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "tokens": shape.tokens,
        "hardware": hardware_model(),
    }
    artifact["roofline"] = roofline_terms(artifact)
    out_path.write_text(json.dumps(artifact, indent=1))
    print(f"[dryrun] {mesh_name} {arch} {shape_name}: OK (build "
          f"{build_s:.1f}s trace {trace_s:.1f}s, peak/device "
          f"{peak / 1e9:.2f} GB)", flush=True)
    return artifact


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="one arch; with --all, its four cells")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--out", default=str(ART_DIR))
    ap.add_argument("--tag", default="", help="variant tag for the artifact")
    ap.add_argument("--rules-json", default="",
                    help='partition-rule overrides, e.g. '
                         '\'{"batch": [["data","model"]]}\'')
    ap.add_argument("--cfg-json", default="",
                    help='ModelConfig overrides, e.g. '
                         '\'{"moe_dispatch": "gather"}\'')
    ap.add_argument("--mu", type=int, default=0,
                    help="override gradient-accumulation depth")
    ap.add_argument("--mesh-shape", type=int, nargs=2, default=None,
                    help="alternative (data, model) carve of the 256-rank "
                         "pod, e.g. 32 8 keeps the model axis in a node")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    rules = None
    if args.rules_json:
        overrides = {k: tuple(tuple(c) for c in v)
                     for k, v in json.loads(args.rules_json).items()}
        rules = PartitionRules(overrides)
    cfg_overrides = json.loads(args.cfg_json) if args.cfg_json else None
    if args.mesh_shape:
        mesh_name = f"pod{args.mesh_shape[0]}x{args.mesh_shape[1]}"
    else:
        mesh_name = "pod2x16x16" if args.multi_pod else "pod16x16"

    todo = []
    if args.all:
        for arch in ([args.arch] if args.arch else ARCHS):
            for shape_name, status in cells(arch):
                if status != "RUN":
                    p = out_dir / mesh_name / f"{arch}__{shape_name}.json"
                    p.parent.mkdir(parents=True, exist_ok=True)
                    p.write_text(json.dumps({
                        "arch": arch, "shape": shape_name, "mesh": mesh_name,
                        "status": status}, indent=1))
                    continue
                todo.append((arch, shape_name))
    else:
        todo.append((args.arch, args.shape))

    failures = []
    t_all = time.time()
    for arch, shape_name in todo:
        suffix = f"__{args.tag}" if args.tag else ""
        p = out_dir / mesh_name / f"{arch}__{shape_name}{suffix}.json"
        if args.skip_done and p.exists():
            try:
                if json.loads(p.read_text()).get("status") == "ok":
                    continue
            except ValueError:
                pass
        try:
            run_cell(arch, shape_name, args.multi_pod, out_dir, rules=rules,
                     cfg_overrides=cfg_overrides, tag=args.tag,
                     mu=args.mu or None, mesh_shape=args.mesh_shape)
        except Exception as e:
            traceback.print_exc()
            failures.append((arch, shape_name, repr(e)))
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(json.dumps({
                "arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "FAIL", "error": repr(e)[:2000]}, indent=1))
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:", file=sys.stderr)
        for f in failures:
            print("  ", f, file=sys.stderr)
        sys.exit(1)
    print(f"[dryrun] all cells OK in {time.time() - t_all:.1f}s")


if __name__ == "__main__":
    main()
