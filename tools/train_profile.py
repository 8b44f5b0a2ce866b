#!/usr/bin/env python3
"""Where a full-width train step spends its device time.

Traces with ``torch.profiler`` on a CUDA card one bf16 train step of
smollm-360m, or ``--arch`` (B=8, S=1024 by default, remat "full", AdamW;
``--layers`` cuts the depth, full width kept; a ``vision_stub`` arch gets
its ``frontend_tokens`` patch positions in front of the S text tokens)
after a warm-up step, and prints as JSON lines the wall time, the summed device
time of the kernels, their ratio (the device's busy share), the kernels
with the most device time, the device time of each of the port's
kernels (K1, K1b, K2, K2b: the CUDA kernels named flash_* and ssd_*), and
the host time of the program's spans summed by name (``repro_torch.trace``:
the step, its forward, backward and optimizer, each layer kind's mixer and
FFN, forward and remat recompute together), on a host the profiler slows.
Weights are random from seed 0, as in chip_smoke.py.  Usage (needs a CUDA
card):
  PYTHONPATH=src python tools/train_profile.py [--arch mamba2-1.3b]
  PYTHONPATH=src python tools/train_profile.py --arch gemma2-9b --layers 4 \
      --batch 1 --seq 8192
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from collections import defaultdict

import numpy as np
import torch

from repro_torch import trace as spans
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, cosine_schedule

from serve_profile import (BATCH, SEQ, TOP, _device_us, port_kernels_ms,
                           prefill_batch, trace)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the arch to this many layers (0: all)")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--seq", type=int, default=SEQ)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    params = T.init_params(cfg, 0, device="cuda")
    opt = AdamW(lr=cosine_schedule(3e-4, 20, 10_000))
    holder = [params, opt.init(params)]
    step = M.make_train_step(cfg, opt)
    rng = np.random.default_rng(0)
    batch = prefill_batch(cfg, args.batch, args.seq + 1, rng)
    toks = batch.pop("tokens")
    batch.update(tokens=toks[:, :-1], targets=toks[:, 1:],
                 loss_mask=torch.ones((args.batch, args.seq), device="cuda"))

    def run():
        holder[0], holder[1], _ = step(holder[0], holder[1], batch)
    wall_us, kernels, _ = trace(run, 1)
    busy_us = sum(_device_us(e) for e in kernels)
    host_ms = defaultdict(float)
    for s in spans.snapshot().spans:
        host_ms[s.name] += s.ms
    print(json.dumps({
        "arch": cfg.name, "layers": cfg.num_layers, "phase": "train",
        "shape": [args.batch, args.seq], "steps": 1, "remat": cfg.remat,
        "wall_ms": wall_us / 1e3, "device_ms": busy_us / 1e3,
        "busy_share": busy_us / wall_us,
        "kernel_launches": sum(e.count for e in kernels),
        "port_kernels_device_ms": port_kernels_ms(kernels),
        "spans_host_ms": dict(sorted(host_ms.items())),
        "top": [{"kernel": e.key[:90], "calls": e.count,
                 "device_ms": _device_us(e) / 1e3}
                for e in kernels[:TOP]]}), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
