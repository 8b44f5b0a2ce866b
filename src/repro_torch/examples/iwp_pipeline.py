"""Ice Wedge Polygons use case (paper §III-B): tiling + inference.

Each very-high-resolution "satellite image" is processed in two stages with
different resource shapes — exactly the paper's heterogeneous pattern:
  tiling    — CPU-slot Python function: split into 360x360 tiles;
  inference — SPMD function on the ranks of a slot block: a small conv net
              scores every tile (the paper's GPU stage), tiles sharded over
              the task's private mesh.

Many images flow through concurrently; per-image dataflow edges are
futures.  The scores stay on the ranks until ``collect``, a Python task,
takes them (its RankRefs come to the host).

    PYTHONPATH=src python -m repro_torch.examples.iwp_pipeline [--device cpu]
"""
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import (DataFlowKernel, P, PilotDescription,
                              RPEXExecutor, python_app, shard_map, spmd_app)
from repro_torch.examples import _args

TILE = 90          # reduced 360 -> 90 for the CPU container
TILES_PER_IMG = 8


@python_app
def load_and_tile(image_id):
    """Stage 1 (CPU): load the scene and cut it into tiles."""
    rng = np.random.default_rng(image_id)
    scene = rng.standard_normal((TILE * 2, TILE * 4)).astype("float32")
    tiles = (scene.reshape(2, TILE, 4, TILE).transpose(0, 2, 1, 3)
             .reshape(TILES_PER_IMG, TILE, TILE))
    return {"image_id": image_id, "tiles": tiles}


@spmd_app(slots=4, mesh=(4, 1), jit=False)
def infer(mesh, payload):
    """Stage 2 (the ranks' devices): score tiles, sharded over 'data'."""
    tiles = torch.as_tensor(payload["tiles"], device=mesh.device)  # (8, T, T)
    # the 5x5 box is symmetric, so this correlation is convolve2d "same"
    kernel = torch.ones(1, 1, 5, 5, device=mesh.device) / 25.0

    def per_shard(t):                              # t: (2, T, T) local tiles
        sm = F.conv2d(t[:, None], kernel, padding=2)[:, 0]
        return torch.sigmoid(sm.mean(dim=(1, 2)))

    f = shard_map(per_shard, mesh=mesh, in_specs=P("data"),
                  out_specs=P("data"))
    return {"image_id": payload["image_id"], "scores": f(tiles)}


@python_app
def collect(results):
    found = {r["image_id"]: float(np.max(r["scores"].numpy()))
             for r in results}
    return found


def main(argv=None):
    ap = _args.parser(__doc__)
    ap.add_argument("--images", type=int, default=12)
    args = ap.parse_args(argv)
    rpex = RPEXExecutor(PilotDescription(n_slots=8, ranks=args.ranks,
                                         devices=_args.devices(args)))
    t0 = time.time()
    with DataFlowKernel(executors={"rpex": rpex}):
        per_image = [infer(load_and_tile(i)) for i in range(args.images)]
        summary = collect(per_image).result()
    rpex.shutdown()
    print(f"[iwp] {args.images} images in {time.time()-t0:.1f}s; "
          f"max polygon scores: "
          f"{ {k: round(v, 3) for k, v in list(summary.items())[:4]} } ...")
    assert len(summary) == args.images
    return summary


if __name__ == "__main__":
    main()
