#!/usr/bin/env python3
"""Where a full-width train step spends its device time.

Traces with ``torch.profiler`` on a CUDA card one bf16 train step of
smollm-360m, or ``--arch`` (B=8, S=1024, remat "full", AdamW) after a
warm-up step, and prints as JSON lines the wall time, the summed device
time of the kernels, their ratio (the device's busy share), the kernels
with the most device time, and the device time of each of the port's
kernels (K1, K1b, K2, K2b: the CUDA kernels named flash_* and ssd_*).
Weights are random from seed 0, as in chip_smoke.py.  Usage (needs a CUDA
card):
  PYTHONPATH=src python tools/train_profile.py [--arch mamba2-1.3b]
"""
from __future__ import annotations

import argparse
import json
import re

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, cosine_schedule

from serve_profile import BATCH, SEQ, TOP, _device_us, trace


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    cfg = get_config(ap.parse_args(argv).arch)
    params = T.init_params(cfg, 0, device="cuda")
    opt = AdamW(lr=cosine_schedule(3e-4, 20, 10_000))
    holder = [params, opt.init(params)]
    step = M.make_train_step(cfg, opt)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).cuda(),
             "targets": torch.from_numpy(toks[:, 1:]).cuda(),
             "loss_mask": torch.ones((BATCH, SEQ), device="cuda")}

    def run():
        holder[0], holder[1], _ = step(holder[0], holder[1], batch)
    wall_us, kernels, _ = trace(run, 1)
    busy_us = sum(_device_us(e) for e in kernels)
    ours = {}
    for e in kernels:
        name = re.search(r"\b(flash|ssd)_\w+_kernel", e.key)
        if name:
            ours[name.group(0)] = ours.get(name.group(0), 0.0) + _device_us(e) / 1e3
    print(json.dumps({
        "arch": cfg.name, "phase": "train", "steps": 1, "remat": cfg.remat,
        "wall_ms": wall_us / 1e3, "device_ms": busy_us / 1e3,
        "busy_share": busy_us / wall_us,
        "kernel_launches": sum(e.count for e in kernels),
        "port_kernels_device_ms": ours,
        "top": [{"kernel": e.key[:90], "calls": e.count,
                 "device_ms": _device_us(e) / 1e3}
                for e in kernels[:TOP]]}), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
