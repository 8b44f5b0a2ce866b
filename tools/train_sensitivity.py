#!/usr/bin/env python3
"""How far one f32 ulp of change in the params moves the gradients.

Reduced smollm-360m in f32 (the size of the CPU train tests), random
params from the reference's init rule (``init_params``: wq, wk and wv
take the head count as fan_in), then the same params with wq, wk and wv
rescaled to fan_in = d_model (``chip_smoke.smoke_params``).  For each,
one loss-and-grad on a seeded batch, again with every param scaled by
1 + 2^-23, and the largest change of each grad leaf relative to that
leaf's largest magnitude.  A tolerance below that change cannot tell a
fault from rounding.  Runs on the CPU (``--device cuda`` on a card):
  PYTHONPATH=src python tools/train_sensitivity.py
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.tree import leaves, tree_map


def grad_change(cfg, params, batch):
    """max over leaves of |g(p) - g(p (1 + 2^-23))| / max |g(p)|."""
    g0, _ = M.make_loss_and_grad(cfg)(params, batch)
    nudged = tree_map(lambda p: p * (1 + 2.0 ** -23), params)
    g1, _ = M.make_loss_and_grad(cfg)(nudged, batch)
    return max(float((a - b).abs().max() / a.abs().max())
               for a, b in zip(leaves(g0), leaves(g1)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(reduce_config(get_config("smollm-360m")),
                              dtype="float32")
    for seed in range(args.seeds):
        params = T.init_params(cfg, seed, device=args.device)
        rng = np.random.default_rng(seed)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 33))
                                ).to(args.device)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                 "loss_mask": torch.ones((2, 32), device=args.device)}
        row = {"seed": seed, "init": grad_change(cfg, params, batch)}
        for layer in params["layers"]:
            for name in ("wq", "wk", "wv"):
                w = layer["mixer"][name]
                w.mul_((w.shape[-2] / w.shape[0]) ** 0.5)
        row["fan_in_d_model"] = grad_change(cfg, params, batch)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
