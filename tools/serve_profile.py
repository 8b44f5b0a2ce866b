#!/usr/bin/env python3
"""Where full-width serving steps spend their device time.

For each arch, traces with ``torch.profiler`` on a CUDA card one bf16
prefill step (B=8, S=1024 by default; a ``vision_stub`` arch gets its
``frontend_tokens`` patch positions in front of the S text tokens) and 4
decode steps at the serve loop's shape (B=4, one token, a 128-long
cache), each after a warm-up call, and prints as JSON lines the wall
time, the summed device time of the kernels, their ratio (the device's
busy share), the kernels with the most device time, and the device time
of the port's own kernels (K1, K2: the CUDA kernels named flash_* and
ssd_*).  For an MoE arch it also splits the MoE FFN's device time by the
program's own spans (``repro_torch.trace``, on while the profiler runs):
the router (``moe.route``), the slot positions (``moe.positions``), the
experts' products (``moe.experts``) and the rest of the MoE FFN
(``layer.moe``), which is the dispatch and combine (the one-hot products
for ``einsum``, the scatter and gathers for ``gather``), each beside K1's.
Weights are random from seed 0, as in chip_smoke.py.  Usage (needs a CUDA
card; ``--layers`` cuts the depth, full width kept):
  PYTHONPATH=src python tools/serve_profile.py
  PYTHONPATH=src python tools/serve_profile.py --arch qwen3-moe-235b-a22b \
      --layers 4 [--dispatch gather]
  PYTHONPATH=src python tools/serve_profile.py --arch gemma2-9b --batch 1 \
      --seq 8192
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace as spans
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models import transformer as T


BATCH, SEQ, TOP = 8, 1024, 12   # chip_smoke.py's prefill shape; kernels shown


MOE_FFN = "layer.moe"                                   # the program's spans
MOE_PARTS = ("moe.route", "moe.positions", "moe.experts")


def _device_us(event):
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0))


def trace(run, steps):
    """Wall time, the kernels' summed device time by name, and the device
    time of the kernels launched inside the MoE FFN's spans, of ``steps``
    calls of ``run``."""
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # the spans' own device-side ranges are not kernels: leave them out
    names = {s.name for s in spans.snapshot().spans}
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in names]
    kernels.sort(key=_device_us, reverse=True)
    ranges = {}
    for e in prof.events():
        if (e.device_type == DeviceType.CPU
                and e.name in (MOE_FFN,) + MOE_PARTS):
            ranges[e.name] = ranges.get(e.name, 0.0) + e.device_time_total
    return wall_us, kernels, ranges


def moe_split(kernels, ranges):
    """Device ms of the MoE FFN's parts and of K1 (the flash kernels)."""
    ms = {name: us / 1e3 for name, us in ranges.items()}
    total = ms.get(MOE_FFN, 0.0)
    ms["dispatch_combine"] = total - sum(ms.get(n, 0.0) for n in MOE_PARTS)
    ms["K1"] = sum(_device_us(e) for e in kernels if "flash" in e.key) / 1e3
    return ms


def port_kernels_ms(kernels):
    """Device ms of each of the port's CUDA kernels, by kernel name."""
    ours = {}
    for e in kernels:
        name = re.search(r"\b(flash|ssd)_\w+_kernel", e.key)
        if name:
            ours[name.group(0)] = (ours.get(name.group(0), 0.0)
                                   + _device_us(e) / 1e3)
    return ours


def prefill_batch(cfg, batch, seq, rng):
    """``batch`` x ``seq`` tokens on the card; a ``vision_stub`` arch gets
    its ``frontend_tokens`` patch positions in front, in the model's dtype."""
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, seq))).cuda()}
    if cfg.frontend == "vision_stub":
        out["patches"] = torch.randn(
            (batch, cfg.frontend_tokens, cfg.d_model), device="cuda",
            dtype=getattr(torch, cfg.dtype))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append",
                    help="repeatable; default smollm-360m and mamba2-1.3b")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut each arch to this many layers (0: all)")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--seq", type=int, default=SEQ,
                    help="text tokens per prefill sequence")
    ap.add_argument("--dispatch", default=None,
                    help="the MoE dispatch, einsum or gather (default: the "
                         "config's)")
    args = ap.parse_args(argv)
    for arch in args.arch or ["smollm-360m", "mamba2-1.3b"]:
        cfg = get_config(arch)
        if args.layers:
            cfg = dataclasses.replace(cfg, num_layers=args.layers)
        if args.dispatch:
            cfg = dataclasses.replace(cfg, moe_dispatch=args.dispatch)
        params = T.init_params(cfg, 0, device="cuda")
        rng = np.random.default_rng(0)
        batch = prefill_batch(cfg, args.batch, args.seq, rng)
        prefill = M.make_prefill_step(cfg)
        decode = M.make_decode_step(cfg)
        cache = T.init_cache(cfg, 4, 128, cfg.dtype, device="cuda")
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 1))).cuda()
        for phase, run, steps in (
                ("prefill", lambda: prefill(params, batch), 1),
                ("decode", lambda: decode(params, tok, cache, 5), 4)):
            wall_us, kernels, ranges = trace(run, steps)
            busy_us = sum(_device_us(e) for e in kernels)
            line = {
                "arch": arch, "layers": cfg.num_layers, "phase": phase,
                "shape": ([args.batch, args.seq] if phase == "prefill"
                          else [4, 1]),
                "steps": steps, "wall_ms": wall_us / 1e3,
                "device_ms": busy_us / 1e3, "busy_share": busy_us / wall_us,
                "kernel_launches": sum(e.count for e in kernels),
                "port_kernels_device_ms": port_kernels_ms(kernels),
                "top": [{"kernel": e.key[:90], "calls": e.count,
                         "device_ms": _device_us(e) / 1e3}
                        for e in kernels[:TOP]]}
            if cfg.num_experts:
                split = moe_split(kernels, ranges)
                line.update(dispatch=cfg.moe_dispatch, moe_device_ms=split,
                            moe_share=split.get(MOE_FFN, 0.0) * 1e3
                            / max(busy_us, 1.0))
            print(json.dumps(line), flush=True)
        del params, cache
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
