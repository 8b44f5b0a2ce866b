#!/usr/bin/env python3
"""Where full-width serving steps spend their device time.

For each arch, traces with ``torch.profiler`` on a CUDA card one bf16
prefill step (B=8, S=1024) and 4 decode steps at the serve
loop's shape (B=4, one token, a 128-long cache), each after a warm-up
call, and prints as JSON lines the wall time, the summed device time of
the kernels, their ratio (the device's busy share), and the kernels with
the most device time.  Weights are random from seed 0, as in
chip_smoke.py.  Usage (needs a CUDA card):
  PYTHONPATH=src python tools/serve_profile.py
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models import transformer as T


BATCH, SEQ, TOP = 8, 1024, 12   # chip_smoke.py's prefill shape; kernels shown


def _device_us(event):
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0))


def trace(run, steps):
    """Wall and summed kernel time of ``steps`` calls of ``run``."""
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=_device_us, reverse=True)
    return wall_us, kernels


def main():
    for arch in ("smollm-360m", "mamba2-1.3b"):
        cfg = get_config(arch)
        params = T.init_params(cfg, 0, device="cuda")
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (BATCH, SEQ))).cuda()
        prefill = M.make_prefill_step(cfg)
        decode = M.make_decode_step(cfg)
        cache = T.init_cache(cfg, 4, 128, cfg.dtype, device="cuda")
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 1))).cuda()
        for phase, run, steps in (
                ("prefill", lambda: prefill(params, {"tokens": toks}), 1),
                ("decode", lambda: decode(params, tok, cache, 5), 4)):
            wall_us, kernels = trace(run, steps)
            busy_us = sum(_device_us(e) for e in kernels)
            print(json.dumps({
                "arch": arch, "phase": phase, "steps": steps,
                "wall_ms": wall_us / 1e3, "device_ms": busy_us / 1e3,
                "busy_share": busy_us / wall_us,
                "kernel_launches": sum(e.count for e in kernels),
                "top": [{"kernel": e.key[:90], "calls": e.count,
                         "device_ms": _device_us(e) / 1e3}
                        for e in kernels[:TOP]]}), flush=True)
        del params, cache
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
