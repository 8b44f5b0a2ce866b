#!/usr/bin/env python3
"""Where a full-width train step spends its device time.

Traces with ``torch.profiler`` on a CUDA card one bf16 train step of
smollm-360m (B=8, S=1024, remat "full", AdamW) after a warm-up step, and
prints as JSON lines the wall time, the summed device time of the kernels,
their ratio (the device's busy share), the kernels with the most device
time, and the device time of the flash kernels K1 and K1b by name.
Weights are random from seed 0, as in chip_smoke.py.  Usage (needs a CUDA
card):
  PYTHONPATH=src python tools/train_profile.py
"""
from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, cosine_schedule

from serve_profile import BATCH, SEQ, TOP, _device_us, trace


def main():
    cfg = get_config("smollm-360m")
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
    wall_us, kernels = trace(run, 1)
    busy_us = sum(_device_us(e) for e in kernels)
    flash = {name: sum(_device_us(e) for e in kernels if name in e.key) / 1e3
             for name in ("flash_fwd_mma_kernel", "flash_bwd_dkdv_wgmma_kernel",
                          "flash_bwd_dq_wgmma_kernel", "flash_bwd_prep_kernel")}
    print(json.dumps({
        "arch": cfg.name, "phase": "train", "steps": 1, "remat": cfg.remat,
        "wall_ms": wall_us / 1e3, "device_ms": busy_us / 1e3,
        "busy_share": busy_us / wall_us,
        "kernel_launches": sum(e.count for e in kernels),
        "flash_device_ms": flash,
        "top": [{"kernel": e.key[:90], "calls": e.count,
                 "device_ms": _device_us(e) / 1e3}
                for e in kernels[:TOP]]}), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
