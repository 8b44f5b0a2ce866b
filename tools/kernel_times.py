#!/usr/bin/env python3
"""Device times of the flash and SSD kernels and of the unsharded main
paths, for comparing two checkouts on one card.

Times with CUDA events, after warm-up, each time the median of
``--reps`` readings (the readings themselves under "readings"):
- K1 (with its lse) and K1b in bf16, causal, at smollm-360m's attention
  (B=8, S=1024, 15 q heads on 5, D=64), a D=128 shape (B=4, S=1024, 16
  on 8) and gemma2-9b's (B=1, S=8192, 16 on 8, D=256, cap 50);
- K1 as the prefill calls it (no lse) at every D <= 128 attention shape
  of PERF.md's kernel table (smollm, qwen3-moe, dbrx, musicgen, granite,
  internlm2 at B=8 S=1024; internvl2 at B=4 S=2048), each beside SDPA's
  forward on the same inputs ("SDPA <arch>", causal, GQA), and at the
  sequence-parallel ranks of smollm's attention (a chunk of S/M q rows at
  offset r S/M against all 1024 keys, M = 2 and 4);
- the SSD chunk kernels K2 and K2b in bf16 at mamba2-1.3b's shape (B=8,
  S=1024, H=64, P=64, N=128, chunk 256; x, B, C split views of one xBC
  tensor at the model's scale, f32 cotangents);
- the prefill steps of smollm-360m, mamba2-1.3b, qwen3-moe-235b-a22b cut
  to 4 layers and internvl2-76b cut to 4 layers (B=4, 1024 patch
  positions before 1024 tokens), and the train steps of smollm-360m and
  mamba2-1.3b (bf16, B=8, S=1024; AdamW, remat "full"), at full width.
Prints one JSON line: the card, its power limit, and each time in ms.  It
calls the kernels' wrappers and the step factories with their
long-standing arguments only, so to compare two checkouts, run it with
each one's ``src`` first on the path, in turns on one card (A, B, B, A):
  PYTHONPATH=build/parent/src python tools/kernel_times.py
  PYTHONPATH=src python tools/kernel_times.py
Weights and inputs are random from fixed seeds (the attention weights of
the stepped models rescaled as chip_smoke.py's ``smoke_params`` does, so
that qwen3-moe routes as there).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

SHAPES = {"smollm": ((8, 1024, 15, 5, 64), 0.0),
          "d128": ((4, 1024, 16, 8, 128), 0.0),
          "gemma2": ((1, 8192, 16, 8, 256), 50.0)}
# K1's attention shapes at D <= 128, (B, S, Hq, Hkv, D)
FWD_SHAPES = {"smollm": (8, 1024, 15, 5, 64),
              "qwen3-moe": (8, 1024, 64, 4, 64),
              "dbrx": (8, 1024, 48, 8, 128),
              "musicgen": (8, 1024, 32, 32, 64),
              "granite": (8, 1024, 32, 8, 64),
              "internlm2": (8, 1024, 16, 8, 128),
              "internvl2": (4, 2048, 64, 8, 128)}
SEQ_SPLITS = (2, 4)             # model-axis sizes of the seq strategy
MAMBA_SSD = (8, 1024, 64, 64, 128, 256)   # (B, S, H, P, N, chunk)


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


def _randn(rng, *shapes):
    return (torch.from_numpy(rng.standard_normal(s, np.float32))
            .to("cuda", torch.bfloat16) for s in shapes)


def kernel_times(reps, read):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    for name, ((B, S, Hq, Hkv, D), cap) in SHAPES.items():
        q, k, v, do = _randn(np.random.default_rng(1), (B, S, Hq, D),
                             (B, S, Hkv, D), (B, S, Hkv, D), (B, S, Hq, D))
        kw = dict(causal=True, window=0, attn_softcap=cap)
        o, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
        iters = 5 if D == 256 else 20
        read(f"K1 {name}", reps, lambda: cuda_ms(
            lambda: flash_attention_fwd(q, k, v, with_lse=True, **kw), iters))
        read(f"K1b {name}", reps, lambda: cuda_ms(
            lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw), iters))
    for name, (B, S, Hq, Hkv, D) in FWD_SHAPES.items():
        q, k, v = _randn(np.random.default_rng(1), (B, S, Hq, D),
                         (B, S, Hkv, D), (B, S, Hkv, D))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        read(f"K1 {name}", reps, lambda: cuda_ms(
            lambda: flash_attention_fwd(q, k, v, causal=True), 20))
        read(f"SDPA {name}", reps, lambda: cuda_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 20))
        if name != "smollm":
            continue
        for M in SEQ_SPLITS:
            for r in range(M):
                c = S // M
                qr = q[:, r * c:(r + 1) * c].contiguous()
                read(f"K1 smollm seq M={M} rank {r}", reps, lambda: cuda_ms(
                    lambda: flash_attention_fwd(qr, k, v, causal=True,
                                                q_offset=r * c), 20))


def ssd_times(reps, read):
    import torch.nn.functional as F
    from repro_torch.kernels.ssd import ssd_chunk_bwd_kernel, ssd_chunk_kernel
    B, S, H, P, N, Q = MAMBA_SSD
    rng = np.random.default_rng(3)
    normal = lambda *s: torch.from_numpy(rng.standard_normal(s, np.float32)).cuda()
    uniform = lambda *s: torch.from_numpy(
        rng.uniform(0.5, 1.5, s).astype(np.float32)).cuda()
    xbc = F.silu(normal(B, S, H * P + 2 * N)).to(torch.bfloat16)
    x, B_, C_ = torch.split(xbc, [H * P, N, N], dim=-1)
    args = (x.unflatten(-1, (H, P)), F.softplus(normal(B, S, H) + uniform(H)),
            -torch.exp(uniform(H)), B_, C_)
    nc = S // Q
    cts = [normal(*s) for s in ((B, S, H, P), (B, H, nc, P, N), (B, H, nc, Q),
                                (B, H, nc))]
    read("K2 mamba2", reps, lambda: cuda_ms(
        lambda: ssd_chunk_kernel(*args, chunk=Q), 20))
    read("K2b mamba2", reps, lambda: cuda_ms(
        lambda: ssd_chunk_bwd_kernel(*args, *cts, chunk=Q), 10))


def _rescaled(cfg, seed):
    """init_params with wq, wk, wv rescaled as chip_smoke's smoke_params."""
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, seed, device="cuda")
    for layer in params["layers"]:
        if "wq" not in layer["mixer"]:
            continue
        for name in ("wq", "wk", "wv"):
            w = layer["mixer"][name]
            w.mul_((w.shape[-2] / w.shape[0]) ** 0.5)
    return params


def step_times(reps, read):
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.optim import AdamW, cosine_schedule
    rng = np.random.default_rng(2)
    for arch, layers, B, patches in (("smollm-360m", None, 8, 0),
                                     ("mamba2-1.3b", None, 8, 0),
                                     ("qwen3-moe-235b-a22b", 4, 8, 0),
                                     ("internvl2-76b", 4, 4, 1024)):
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        params = _rescaled(cfg, 0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (B, 1025))).cuda()
        batch = {"tokens": toks[:, :-1]}
        if patches:
            batch["patches"] = torch.from_numpy(
                (rng.standard_normal((B, patches, cfg.d_model)) * 0.02)
                .astype(np.float32)).cuda()
        prefill = M.make_prefill_step(cfg)
        name = f"{arch} prefill" + (f" {layers} layers" if layers else "")
        read(name, reps, lambda: cuda_ms(lambda: prefill(params, batch), 5))
        if arch in ("smollm-360m", "mamba2-1.3b"):
            opt = AdamW(lr=cosine_schedule(3e-4, 20, 10_000))
            state = [params, opt.init(params)]
            step = M.make_train_step(cfg, opt)
            tb = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                  "loss_mask": torch.ones((8, 1024), device="cuda")}

            def run():
                state[0], state[1], _ = step(state[0], state[1], tb)
            read(f"{arch} train step", reps,
                 lambda: cuda_ms(run, 5, warmup=2))
            del state
        del params
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5,
                    help="readings of each time; the median is reported")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("kernel_times: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    import repro_torch
    out, readings = {}, {}

    def read(name, reps, fn):
        readings[name] = [fn() for _ in range(reps)]
        out[name] = statistics.median(readings[name])
    kernel_times(args.reps, read)
    ssd_times(args.reps, read)
    step_times(max(args.reps // 2, 1), read)
    print(json.dumps({"card": card, "package": repro_torch.__file__, **out,
                      "readings": readings}))


if __name__ == "__main__":
    main()
