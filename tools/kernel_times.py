#!/usr/bin/env python3
"""Device times of the flash kernels and of the unsharded main paths, for
comparing two checkouts on one card.

Times with CUDA events, after warm-up: K1 (with its lse) and K1b in bf16,
causal, at smollm-360m's attention (B=8, S=1024, 15 q heads on 5, D=64),
a D=128 shape (B=4, S=1024, 16 on 8) and gemma2-9b's (B=1, S=8192, 16 on
8, D=256, cap 50); then smollm-360m's prefill step and train step at full
width and depth (bf16, B=8, S=1024; AdamW, remat "full") and mamba2-1.3b's
prefill step.  Prints one JSON line: the card, its power limit, and each
time in ms.  It calls the kernels' wrappers and the step factories with
their long-standing arguments only, so to compare two checkouts, run it
with each one's ``src`` first on the path, in turns on one card (A, B, B,
A):
  PYTHONPATH=build/parent/src python tools/kernel_times.py
  PYTHONPATH=src python tools/kernel_times.py
Weights and inputs are random from fixed seeds.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

SHAPES = {"smollm": ((8, 1024, 15, 5, 64), 0.0),
          "d128": ((4, 1024, 16, 8, 128), 0.0),
          "gemma2": ((1, 8192, 16, 8, 256), 50.0)}


def cuda_ms(fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_times():
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    out = {}
    for name, ((B, S, Hq, Hkv, D), cap) in SHAPES.items():
        rng = np.random.default_rng(1)
        q, k, v, do = (torch.from_numpy(rng.standard_normal(s, np.float32))
                       .to("cuda", torch.bfloat16)
                       for s in ((B, S, Hq, D), (B, S, Hkv, D),
                                 (B, S, Hkv, D), (B, S, Hq, D)))
        kw = dict(causal=True, window=0, attn_softcap=cap)
        o, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
        iters = 5 if D == 256 else 20
        out[f"K1 {name}"] = cuda_ms(
            lambda: flash_attention_fwd(q, k, v, with_lse=True, **kw), iters)
        out[f"K1b {name}"] = cuda_ms(
            lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw), iters)
    return out


def step_times():
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamW, cosine_schedule
    out = {}
    rng = np.random.default_rng(2)
    for arch in ("smollm-360m", "mamba2-1.3b"):
        cfg = get_config(arch)
        params = T.init_params(cfg, 0, device="cuda")
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (8, 1025))).cuda()
        prefill = M.make_prefill_step(cfg)
        out[f"{arch} prefill"] = cuda_ms(
            lambda: prefill(params, {"tokens": toks[:, :-1]}), 5)
        if arch == "smollm-360m":
            opt = AdamW(lr=cosine_schedule(3e-4, 20, 10_000))
            state = [params, opt.init(params)]
            step = M.make_train_step(cfg, opt)
            batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                     "loss_mask": torch.ones((8, 1024), device="cuda")}

            def run():
                state[0], state[1], _ = step(state[0], state[1], batch)
            out[f"{arch} train step"] = cuda_ms(run, 5, warmup=2)
        del params
        torch.cuda.empty_cache()
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("kernel_times: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    import repro_torch
    print(json.dumps({"card": card, "package": repro_torch.__file__,
                      **kernel_times(), **step_times()}))


if __name__ == "__main__":
    main()
