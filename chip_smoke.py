#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises on failure:
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: every CUDA source under src/repro_torch/kernels/csrc, all at
     once, with the compiler's register / shared-memory / spill report and
     the count of tensor-core instructions (HMMA, HGMMA) in each library's
     SASS; a library without any fails, and so does a wgmma kernel (K1's
     and K1b's bf16 kernels at head dims 64, 128 and 256) without HGMMA
     or with spills, whose count and registers are reported per kernel;
  3. each kernel against its plain PyTorch version on the card, over the
     reference's sweep grids (tests/test_kernels.py) and the main paths'
     shapes: flash attention (K1) and the SSD chunk terms (K2), and
     ``ops.ssd`` from a nonzero state against the step-by-step recurrence;
     the SSD backward (K2b) over the sweep and the mamba2 shape, f32 and
     bf16, and with Mamba2's published dt/A draw (decays past 88 within a
     chunk), each call twice and bitwise equal, and the gradients of
     ``ops.ssd`` (K2, K2b, the recurrence) from a nonzero state, dh0
     included, against autograd through the recurrence; the recurrence
     between chunks, K3 and K3b, against their plain versions at mamba2's
     train and score shapes and jamba's head dim 128, bf16 and f32, and
     over the sweep, each call twice and bitwise equal, and ``ops.ssd``'s
     aten op count the same at 4 and 16 chunks (no loop over chunks);
  4. smollm-360m prefill at full width (bf16, B=8, S=1024) through
     ``make_prefill_step``, with every kernel launch counted, and its
     logits against the same step through the plain attention; then
     prefill against token-by-token decode at full width in f32, and the
     serve loop at full width (``repro_torch.launch.serve.main``);
  5. the same for mamba2-1.3b: prefill at full width (bf16, B=8, S=1024,
     48 launches each of the SSD chunk kernel K2 and the recurrence K3, dt and A drawn as Mamba2's published
     init draws them: ``mamba_smoke_params``), kernel route against plain
     route per layer and in the logits; f32 prefill (12 layers, B=2,
     S=512, two chunks) against 512 decode steps; the serve loop;
  6. training (smollm-360m): K1 writing its lse against its plain version,
     and the flash backward K1b against its plain version over the sweep
     grid, the training shape (B=8, S=1024), a D=128 shape (B=4, S=1024,
     Hq=16, Hkv=8) and shapes with rows that see no key (Sq > Skv and a
     window), each call run twice and required bitwise equal; on those
     rows K1 and K1b held to their contract (o = 0, lse = -1e30, no
     gradient; a D=256 shape among them); K1 and K1b at head dim 256,
     gemma2-9b's attention shape (B=1, S=8192, Hq=16, Hkv=8, cap 50, the
     4096 window and none), f32 and bf16, against their plain versions,
     K1b twice and bitwise equal;
     one loss-and-grad at full width (4 layers, f32) by the kernel route
     against the plain route; then the train driver
     (``repro_torch.launch.train.main``) at full width cut to 8 layers in
     bf16 through the
     runtime (``repro_torch.core``): ``train_segment`` pilot tasks of 2
     steps beside ``evaluate`` and ``commit_checkpoint`` tasks, 4 steps
     with checkpoints, again with a slot of the running segment failed
     (``--inject-failure 1``: the segment is retried and runs no step
     twice), and a restart from the checkpoint to step 6; K1 and K1b
     counted around each run and inside each segment's body, the device's
     peak after each segment, the runtime's overhead from its events;
     mamba2-1.3b training: loss and grad at full width (4 layers, f32, B=2,
     S=512) by the kernel route (K2 and K2b) against the plain route; the
     train step at full width (bf16, B=8, S=1024, remat "full", AdamW, 5
     steps on one batch: 96 K2 and K3 and 48 K2b and K3b launches a step,
     the loss falling, step time and peak), then the train driver on it (2
     segments of 2 steps through the runtime);
  7. the MoE archs (``phase_moe``): qwen3-moe-235b-a22b at full width cut
     to 4 layers, bf16 prefill (B=8, S=1024; 4 K1 launches and nothing
     else), K1 against its plain version in each layer, the logits
     against the plain route with each layer's expert choices replayed
     (and, as a report, the share of choices that differ without the
     replay), the dropped assignments, the ``gather`` dispatch against
     ``einsum`` and the step under each; the serve loop on the same
     params; f32 prefill against decode at 2 layers, drop-free; dbrx-132b
     at full width cut to 2 layers, the same prefill checks; jamba's
     hybrid at its reduced config (2 K1 and 14 K2 launches, each kernel
     per layer against its plain version, f32 prefill against decode,
     the serve loop); training behind them: jamba reduced, loss and grad
     by the kernel route (K1, K1b, K2, K2b) against the plain route with
     each MoE call's expert choices replayed; qwen3-moe-235b-a22b at full
     width cut to 1 layer, a bf16 loss and grad (all finite; 2 K1 and 1
     K1b launches) and 3 AdamW steps, timed, with the peak;
  8. the other five archs, with ``smoke_params``: gemma2-9b at full width
     and depth (``phase_gemma``): bf16 prefill at B=1, S=8192 (42 K1
     launches at head dim 256, cap 50, the 4096 window cutting on the 21
     local layers; K1 against its plain version in each layer, the logits
     against the plain route), the serve loop; f32 at 2 layers: prefill
     against 4352 decode steps (past the window) and loss and grad by both
     routes at S=6144; bf16 training cut to 4 layers at B=1, S=8192 (8 K1
     and 4 K1b launches a step, the loss falling); internvl2-76b at full
     width (``phase_vlm``): prefill at 4 layers, B=4, 1024 patch positions
     through the connector in front of 1024 text tokens, kernel route
     against plain route; a loss and grad at 1 layer (the connector's
     grads nonzero, the loss over the text positions alone) and AdamW
     steps; the train driver on its reduced config, patches from the data
     pipeline to the loss; musicgen-large, granite-3-2b and internlm2-1.8b
     at full width (``phase_dense_archs``, cut to 12, 10 and 12 layers):
     bf16 prefill (B=8, S=1024, kernel vs plain route), the serve loop
     and 3 AdamW steps each, then the train driver on internlm2 (2
     segments of 2 steps);
     before each of these train steps, every layer's K1 (with lse) and K1b
     against their plain versions on the path's own inputs;
  9. timings with CUDA events: each kernel, its plain version, one PyTorch
     library call as a yardstick where one computes the same function, K1
     with and without its lse, K1b at D=64 and D=128 beside SDPA's
     backward, K1 and K1b at gemma2's D=256 shape (cap 50, and cap 0
     like for like) beside SDPA's forward and backward and their plain
     versions, K2b and the whole SSD backward at the mamba2 shape,
     the prefill and train steps (a train_segment task's time beside the
     same steps called directly), serve throughput, peak memory; K1 and
     K1b at the attention shapes of musicgen, granite, internlm2 and
     internvl2 beside SDPA, and K1 and K1b at gemma2's local layers (the
     window) beside SDPA's forward and backward given the window as a
     mask;
 10. sharding: ``phase_seq_shards``, each rank's K1 and K1b of the
     sequence-parallel strategy at its ``q_offset`` (smollm-360m's
     attention with 2 and 4 ranks, gemma2-9b's with 2, global and the 4096
     window) against their plain versions and, put together, against the
     unsharded call, with each rank's time; ``phase_mesh``, a one-rank
     NCCL ``DeviceMesh`` driving smollm-360m's train step at full width
     and depth (3 steps) and mamba2-1.3b's prefill through ``sharded_ssd``,
     and an f32 loss and grad at 4 layers, against the unsharded paths,
     with their exact launch counts and every param, moment and grad a
     DTensor on the card;
 11. the pilot world (``phase_spmd_world``): smollm-360m's full-width train
     steps and prefill as tasks on a one-rank NCCL world
     (``PilotDescription(ranks=1)``), the params and moments left on the
     rank between tasks (no tensor byte crosses until a Python task fetches
     the last position's logits), K1 and K1b against their plain versions
     on the rank's own inputs, exact launch counts read inside the rank,
     losses, param changes and logits equal (1e-6) to the same bodies in
     this process; the
     quickstart, colmena and IWP bodies on two gloo ranks sharing the card
     against one rank; exp1's no-op psum workload, TPT and TS with the
     groups cached and cold, the body eager and compiled in the rank
     (``torch.compile`` once per key cached, every task cold; the
     compiled runs on 4 slots alone);
 12. the train driver on a pilot world (``phase_train_world``):
     ``repro_torch.launch.train.main`` with ``--data-shards 2`` on
     smollm-360m at full width cut to 8 layers (bf16, B=8, S=1024), the
     driver starting 2 gloo ranks that share the card and keeping the
     state there: 4 steps with checkpoints and an evaluation and a restart
     to step 6, 16 K1 and 8 K1b a step counted in each rank, the losses
     against the in-process driver's (the same cut), no tensor byte across the world's
     boundary, each rank's peak flat; the fault drill at the reduced
     config (a rank killed, the world restarted, the losses equal);
 13. cost accounting (``phase_cost``): smollm-360m's train step,
     gemma2-9b's prefill and mamba2-1.3b's train step counted by
     ``repro_torch.roofline.counter`` on ``meta`` tensors and on the card
     with the kernels launched (FLOPs, bytes and the kernels' costs equal
     exactly, the meta peak within 10% of the allocator's), each step's
     share of the bf16 peak from its model FLOPs; then the dry-run CLI on
     the host's CPU on the fake 16 x 16 world (smollm-360m train_4k and
     gemma2-9b prefill_32k at full width and depth, each ``ok``).  The
     timing phases take every kernel's bound from ``kernels/cost.py``.
Each phase logs its own seconds.
Every main path is driven with all launch counts set to 0 just before it
and read just after.  It prints one JSON line {"kernels": [...]} and, as
its last line, {"ok": true, "device": {...}}.  Without a CUDA card, or
without the port's sources beside it, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
H100_BF16_FLOPS = 989e12       # dense tensor-core peak, NVIDIA H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12     # HBM3 bandwidth, same source
SWEEP = [(1, 32, 2, 2, 16), (2, 64, 4, 2, 32), (1, 100, 8, 8, 64),
         (2, 96, 6, 3, 16), (1, 128, 16, 4, 64)]   # tests/test_kernels.py
WINDOW_CAP = [(0, 0.0), (13, 0.0), (0, 30.0), (13, 30.0)]
TOL = {torch.float32: 3e-5, torch.bfloat16: 3e-2}  # tests/test_kernels.py
PREFILL_B, PREFILL_S = 8, 1024
# bf16 logits, kernel route against plain route: 0.1 is the reference's own
# tolerance between two attention routes in bf16 (prefill vs decode,
# tests/test_models_smoke.py).  The two routes round p to bf16 at different
# points (unnormalised per kv tile in the kernel, normalised in the plain
# version) in each of 32 layers; with the weights of smoke_params that
# moves the logits by about 0.013 (PERF.md).  For mamba2 the weights of
# mamba_smoke_params keep the same tolerance meaningful
PREFILL_TOL = 0.1
# SSD chunk terms, kernel against plain: the reference's own SSD tolerance
# (tests/test_kernels.py); both compute in f32 from the same inputs
SSD_TOL = 5e-4
SSD_SWEEP = [(1, 32, 2, 8, 4, 8), (2, 64, 4, 16, 8, 16), (1, 128, 2, 32, 16, 32),
             (2, 48, 3, 8, 8, 16)]   # (B, S, H, P, N, chunk), tests/test_kernels.py
MAMBA_SHAPE = (PREFILL_B, PREFILL_S, 64, 64, 128, 256)   # mamba2-1.3b prefill
# the SSD kernels' two bf16 routes (kernels/ssd.py::ssd_route): jamba's
# published head dim P = 128 at N = 128, Q = 256 (wgmma), and the edge of
# the wgmma route (P 64 or 128, N a multiple of 16 up to 256, Q a multiple
# of 64 up to 256) against mma.sync, with the route each must take
SSD_ROUTE_SHAPES = [((2, 512, 4, 128, 128, 256), "wgmma"),
                    ((2, 256, 3, 64, 16, 64), "wgmma"),
                    ((1, 256, 2, 64, 256, 256), "wgmma"),
                    ((1, 256, 2, 64, 8, 64), "mma"),
                    ((1, 256, 2, 64, 128, 32), "mma"),
                    ((1, 256, 2, 32, 128, 256), "mma")]
# flash backward, kernel against plain: f32 5e-5 is the reference's own
# tolerance for its VJP (tests/test_kernels.py); bf16 3e-2 as the forward's
BWD_TOL = {torch.float32: 5e-5, torch.bfloat16: 3e-2}
# and per tensor, ||kernel - plain|| / ||plain||: most of the training
# shape's gradients are small, where 3e-2 elementwise is loose; the bf16
# rounding of p and ds moves the norm by a few 1e-3 (PERF.md)
BWD_NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# K1 on the model paths and at head dim 256, beside TOL elementwise: o
# normwise within K1b's gate, and lse within 1e-3 absolute.  At gemma2's
# shape a late row's o entries are about 0.02, under TOL's 3e-2 atol, and
# lse about 9.5 (a 0.3 limit), so TOL alone holds a long row only through
# the tails of a few heavy keys; a kernel that loses a share f of a row's
# softmax mass moves its lse by about f.  The kernel's readings and those
# of controls that drop kv tiles (tools/kernel_variants.py) are in PERF.md
FWD_NORM_TOL = BWD_NORM_TOL
LSE_TOL = 1e-3
TRAIN_SHAPE = (PREFILL_B, PREFILL_S, 15, 5, 64)   # smollm-360m, B=8, S=1024
D128_SHAPE = (4, 1024, 16, 8, 128)                # internlm2-like heads
# rows that see no key: (B, Sq, Skv, Hq, Hkv, D), causal, window 13; rows
# from Skv + 12 on see none.  D=16 is the shape of
# tests/test_torch_flash_nokey.py; D=64, 128 and 256 reach K1's and
# K1b's wgmma paths
NOKEY_SHAPES = [(1, 96, 32, 2, 1, 16), (1, 96, 32, 2, 1, 64),
                (1, 160, 32, 4, 2, 128), (1, 160, 32, 2, 1, 256)]
NOKEY_WINDOW = 13
# train route comparison, f32 at full width, 4 layers, B=2, S=256: loss
# within 1e-4, each grad leaf within 1e-3 of its largest magnitude
ROUTE_LAYERS, ROUTE_B, ROUTE_S = 4, 2, 256
ROUTE_LOSS_TOL, ROUTE_GRAD_TOL = 1e-4, 1e-3
TRAIN_ARGV = ["--arch", "smollm-360m", "--batch", "8", "--seq", "1024",
              "--segment", "2", "--ckpt-every", "2", "--eval-every", "4"]
# the train driver's runs in process cut to 8 of smollm-360m's 32 layers
# (the chip script took 699.8 s of a 600 s aim on an H100 80GB HBM3 at
# 700 W; a full-depth checkpoint is 3.6 GB of state a commit): its
# runtime paths do not change with depth
DRIVER_LAYERS = 8
# gemma2-9b's attention (configs/gemma2_9b.py): 16 q heads on 8 kv heads,
# head dim 256, attention cap 50, local layers with a 4096 window; B=1,
# S=8192
GEMMA_SHAPE = (1, 8192, 16, 8, 256)
GEMMA_CAP, GEMMA_WINDOW = 50.0, 4096
# the MoE archs (configs/qwen3_moe_235b_a22b.py, dbrx_132b.py,
# jamba_1_5_large_398b.py) and their depth cuts at full width
QWEN, DBRX, JAMBA = "qwen3-moe-235b-a22b", "dbrx-132b", "jamba-1.5-large-398b"
MOE_LAYERS, MOE_DECODE_LAYERS, DBRX_LAYERS = 4, 2, 2
# the tensor-core instructions each library's SASS must hold: mma.sync
# (HMMA) in K1 at D = 16 and 32, in K2's and K2b's mma.sync route (the
# bf16 shapes off the wgmma route) and in K3's and K3b's bf16 route, wgmma (HGMMA) in K1's and K1b's bf16
# paths at D = 64, 128 and 256 and in K2's and K2b's wgmma route (their f32
# operands split in three bf16 parts).  Every built library needs an entry
TENSOR_CORE_OPS = {"flash_attention_fwd": ("HMMA", "HGMMA"),
                   "ssd_chunk": ("HMMA", "HGMMA"),
                   "flash_attention_bwd": ("HGMMA",),
                   "ssd_chunk_bwd": ("HMMA", "HGMMA"),
                   "ssd_pass": ("HMMA",)}
# the wgmma kernels that must hold HGMMA and spill nothing in every
# instantiation, and whose registers, spills and shared memory the build
# phase reports from ptxas: K1's at D = 64, 128 and 256 (one template),
# K1b's dq at 64 and 128, and K1b's at 256; K2's and K2b's at P = 64 and
# 128.  K1b's dk/dv at 64 and 128 is left out: at D = 64 under the cap,
# two blocks an SM (168 registers), it spills 20 bytes (ROADMAP)
WGMMA_KERNELS = {"flash_attention_fwd": ("flash_fwd_wgmma_kernel",),
                 "flash_attention_bwd": ("flash_bwd_dq_wgmma_kernel",
                                         "flash_bwd_dkdv_wgmma256_kernel",
                                         "flash_bwd_dq_wgmma256_kernel"),
                 "ssd_chunk": ("ssd_chunk_wgmma_kernel",),
                 "ssd_chunk_bwd": ("ssd_bwd_chunk_wgmma_kernel",
                                   "ssd_bwd_heads_wgmma_kernel")}
# SSD backward, kernel against plain: each gradient within SSD_TOL (atol +
# rtol) and, per tensor, ||kernel - plain|| / ||plain|| within 1e-5, K1b's
# f32 gate: both compute in f32 from the same inputs, cum in f64.  For bf16
# x, dx comes in bf16, rounded once from its f32 sum: it is held against
# the plain version's f32 sum, through that one rounding (check_rounded)
SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC")
SSD_BWD_NORM_TOL = 1e-5
# mamba2-1.3b training: the main path at full width (bf16, B=8, S=1024,
# remat "full", AdamW, 5 steps on one batch); the route comparison at full
# width cut to 4 layers, f32, B=2, S=512 (two chunks of 256, so the
# recurrence between chunks is differentiated too); the train driver, 2
# segments of 2 steps
MAMBA = "mamba2-1.3b"
MAMBA_TRAIN_STEPS = 5
MAMBA_ROUTE_LAYERS, MAMBA_ROUTE_B, MAMBA_ROUTE_S = 4, 2, 512
MAMBA_TRAIN_ARGV = ["--arch", MAMBA, "--batch", "8", "--seq", "1024",
                    "--segment", "2", "--steps", "4", "--ckpt-every", "4",
                    "--eval-every", "4"]
# qwen3-moe-235b-a22b training at full width cut to 1 layer, bf16, B=8,
# S=1024: 3.70 B params, 44.4 GB of params, grads and f32 moments
QWEN_TRAIN_LAYERS, QWEN_TRAIN_STEPS = 1, 3
# the other five archs (configs/gemma2_9b.py, internvl2_76b.py,
# musicgen_large.py, granite_3_2b.py, internlm2_1_8b.py).  gemma2-9b:
# prefill at full depth at GEMMA_SHAPE's B=1, S=8192 (the 4096 window cuts
# on its 21 local layers); in f32 at 2 layers (one local, one global),
# prefill against decode past the window (S=4352) and the route
# comparison (B=1, S=6144: three loss chunks); training cut to 4 layers
# (1.710 B params, 20.5 GB of params, grads and f32 moments) at B=1,
# S=8192
GEMMA, VLM = "gemma2-9b", "internvl2-76b"
GEMMA_B, GEMMA_S = GEMMA_SHAPE[:2]
GEMMA_F32_LAYERS, GEMMA_DECODE_S, GEMMA_ROUTE_S = 2, 4352, 6144
GEMMA_TRAIN_LAYERS, GEMMA_TRAIN_STEPS = 4, 4
# internvl2-76b: prefill at 4 of 80 layers (5.658 B params) and a train
# step at 1 layer (3.091 B params, 37.1 GB with grads and moments), B=4,
# 1024 patch positions (frontend_tokens) in front of 1024 text tokens; the
# train driver on its reduced config
VLM_LAYERS, VLM_TRAIN_LAYERS, VLM_B, VLM_TRAIN_STEPS = 4, 1, 4, 2
VLM_DRIVER_ARGV = ["--arch", VLM, "--reduced", "--batch", "2", "--seq", "64",
                   "--segment", "2", "--steps", "4", "--ckpt-every", "4",
                   "--eval-every", "4"]
# musicgen-large, granite-3-2b and internlm2-1.8b at full width (depth cut
# below): prefill, serve and train at B=8, S=1024; the train driver on
# internlm2 (its untied head, K1b's D=128 wgmma path), 2 segments of 2 steps
DENSE = ("musicgen-large", "granite-3-2b", "internlm2-1.8b")
DENSE_TRAIN_STEPS = 3
# depth cuts that keep the run within its time since the sharding phases
# came: musicgen's and granite's train steps and, since the train driver
# on a world came, their prefill and serve too; internlm2 and its driver
# since the chip script took 699.8 s (of a 600 s aim; H100 80GB HBM3,
# 700 W); and mamba2's f32
# prefill against decode
DENSE_TRAIN_LAYERS = {"musicgen-large": 12, "granite-3-2b": 10,
                      "internlm2-1.8b": 12}
MAMBA_DECODE_LAYERS = 12
DENSE_DRIVER = "internlm2-1.8b"
DENSE_DRIVER_ARGV = ["--arch", DENSE_DRIVER, "--batch", "8", "--seq", "1024",
                     "--segment", "2", "--steps", "4", "--ckpt-every", "4",
                     "--eval-every", "4", "--layers",
                     str(DENSE_TRAIN_LAYERS[DENSE_DRIVER])]


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
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


def in_turns(kern, lib, iters):
    """``kern`` and ``lib`` timed in turns (kernel, library, library,
    kernel): ([kernel ms, kernel ms], [library ms, library ms])."""
    t_k = [cuda_ms(kern, iters=iters)]
    t_l = [cuda_ms(lib, iters=iters), cuda_ms(lib, iters=iters)]
    t_k.append(cuda_ms(kern, iters=iters))
    return t_k, t_l


def bound(flops, nbytes):
    """(bound ms, "operations" or "bytes"): the larger of ``flops`` at the
    card's bf16 tensor-core peak and ``nbytes`` at its memory rate."""
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def qkv(shape, dtype, seed):
    """q, k, v for (B, S, Hq, Hkv, D), or (B, Sq, Skv, Hq, Hkv, D)."""
    B, Sq, Skv, Hq, Hkv, D = shape if len(shape) == 6 else (shape[:2]
                                                            + shape[1:])
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s, np.float32))
                 .to("cuda", dtype)
                 for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))


def sweep_cases(extra=()):
    """(shape, window, cap) of the sweep grid, then the no-key shapes with
    their window, with and without a cap, then ``extra`` shapes bare."""
    return ([(shape, w, c) for shape in SWEEP for w, c in WINDOW_CAP]
            + [(shape, NOKEY_WINDOW, c) for shape in NOKEY_SHAPES
               for c in (0.0, 30.0)]
            + [(shape, 0, 0.0) for shape in extra])


def kernel_counters():
    """The launch counter of each kernel wrapper, by kernel name."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    from repro_torch.kernels.ssd import ssd_chunk_bwd_kernel, ssd_chunk_kernel
    from repro_torch.kernels.ssd_pass import (ssd_pass_bwd_kernel,
                                              ssd_pass_kernel)
    return {"flash_attention_fwd": flash_attention_fwd,
            "flash_attention_bwd": flash_attention_bwd,
            "ssd_chunk_kernel": ssd_chunk_kernel,
            "ssd_chunk_bwd_kernel": ssd_chunk_bwd_kernel,
            "ssd_pass_kernel": ssd_pass_kernel,
            "ssd_pass_bwd_kernel": ssd_pass_bwd_kernel}


def reset_launches():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def max_excess(got, want, tol):
    """max |got-want| and whether it is within atol=rtol=tol everywhere."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ok = bool((diff <= tol + tol * want.abs()).all())
    return float(diff.max()), ok


def norm_error(got, want):
    """||got-want|| / ||want||, over the whole tensor."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def fwd_readings(o, want_o, lse=None, want_lse=None):
    """K1 against its plain version: o's max |kernel - plain|, o's normwise
    error and lse's max |kernel - plain| (0 without lse); whether o and lse
    are within TOL (atol = rtol) everywhere, and whether they also meet
    FWD_NORM_TOL and LSE_TOL."""
    tol = TOL[o.dtype]
    err, ok = max_excess(o, want_o, tol)
    rel = norm_error(o, want_o)
    lse_err, lse_ok = ((0.0, True) if lse is None
                       else max_excess(lse, want_lse, tol))
    return {"o": err, "normwise": rel, "lse": lse_err,
            "elementwise_ok": ok and lse_ok,
            "ok": (ok and lse_ok and rel <= FWD_NORM_TOL[o.dtype]
                   and lse_err <= LSE_TOL)}


def check_fwd(what, o, want_o, lse=None, want_lse=None):
    """``fwd_readings``, raising where a gate fails."""
    r = fwd_readings(o, want_o, lse, want_lse)
    if not r["ok"]:
        raise AssertionError(
            f"flash_attention_fwd {what}: o max |kernel-plain| {r['o']} (tol "
            f"{TOL[o.dtype]} abs + rel), normwise {r['normwise']} (tol "
            f"{FWD_NORM_TOL[o.dtype]}); lse max |kernel-plain| {r['lse']} "
            f"(tol {TOL[o.dtype]} abs + rel and {LSE_TOL} abs)")
    return r


def phase_environment():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device 0: "
        f"{torch.cuda.get_device_name(0)}")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 where compared
    torch.backends.cudnn.allow_tf32 = False
    log("allow_tf32: matmul False, cudnn False")
    return card


def phase_build():
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    t0 = time.time()
    counts = {}
    libs = _build.build()
    log(f"[build] {len(libs)} source(s) in {time.time() - t0:.1f}s: "
        + ", ".join(p.name for p in libs.values()))
    for name in libs:
        log(f"[build] nvcc -Xptxas -v, {name}:\n{_build.build_log(name)}")
    # each library's SASS, read by cuobjdump processes at once
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        sass = dict(zip(libs, pool.map(tensor_core_instructions,
                                       libs.values())))
    for name, lib in libs.items():
        funcs = sass[name]
        counts[name] = {op: sum(f[op] for f in funcs.values())
                        for op in ("HMMA", "HGMMA")}
        log(f"[build] {name}: tensor-core instructions in the SASS "
            + ", ".join(f"{op} {n}" for op, n in counts[name].items())
            + f" (required: {', '.join(TENSOR_CORE_OPS[name]) or 'none'})")
        missing = [op for op in TENSOR_CORE_OPS[name] if not counts[name][op]]
        if missing:
            raise AssertionError(f"{name}: no {', '.join(missing)} in "
                                 f"{lib.name}'s SASS")
        report = ptxas_report(_build.build_log(name))
        for kernel in WGMMA_KERNELS.get(name, ()):
            found = {f: c for f, c in funcs.items() if kernel in f}
            if not found or not all(c["HGMMA"] for c in found.values()):
                raise AssertionError(f"{name}: {kernel} is missing or holds "
                                     f"no HGMMA: {found}")
            for f, c in sorted(found.items()):
                info = next((v for k, v in report.items() if f in k), {})
                counts[name].setdefault("wgmma", {})[f] = {**c, **info}
                log(f"[build] {name}: {f}: HGMMA {c['HGMMA']}, ptxas "
                    f"{info}")
                if info.get("spill_stores") or info.get("spill_loads"):
                    raise AssertionError(f"{name}: {f} spills: {info}")
    return counts


def tensor_core_instructions(lib):
    """HMMA (mma.sync) and HGMMA (wgmma) instructions in each function of a
    library's SASS, from ``cuobjdump -sass``: {mangled name: {op: n}}."""
    cuda_bin = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin"
    tool = shutil.which("cuobjdump") or str(cuda_bin / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    funcs = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name, _, body = part.partition("\n")
        funcs[name.strip()] = {op: len(re.findall(rf"\b{op}\b", body))
                               for op in ("HMMA", "HGMMA")}
    return funcs


def ptxas_report(log_text):
    """Registers, spill bytes and shared memory of each kernel in an
    ``nvcc -Xptxas -v`` log: {mangled name: {...}}."""
    out = {}
    for part in log_text.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          part)
        smem = re.search(r"(\d+) bytes smem", part)
        out[name] = {"registers": int(regs.group(1)) if regs else None,
                     "spill_stores": int(spill.group(1)) if spill else None,
                     "spill_loads": int(spill.group(2)) if spill else None,
                     "static_smem": int(smem.group(1)) if smem else 0}
    return out


def phase_kernel_vs_plain():
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)
    worst = {}
    for shape, window, cap in sweep_cases():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = qkv(shape, dtype, seed=0)
            got = flash_attention_fwd(q, k, v, causal=True, window=window,
                                      attn_softcap=cap)
            torch.cuda.synchronize()
            want = flash_attention_plain(q, k, v, causal=True,
                                         window=window, attn_softcap=cap)
            err, ok = max_excess(got, want, TOL[dtype])
            if not ok:
                raise AssertionError(
                    f"flash_attention_fwd {shape} {dtype} window={window} "
                    f"cap={cap}: max |kernel-plain| {err} over tol "
                    f"{TOL[dtype]}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
    log(f"[kernel] sweep of {len(SWEEP)} shapes x 2 dtypes x 4 window/cap "
        f"and the no-key shapes {NOKEY_SHAPES}: "
        + ", ".join(f"{dt} max |kernel-plain| {e:.3g}" for dt, e in worst.items()))
    shape = (PREFILL_B, PREFILL_S, 15, 5, 64)
    q, k, v = qkv(shape, torch.bfloat16, seed=1)
    got = flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    err, ok = max_excess(got, flash_attention_plain(q, k, v, causal=True),
                         TOL[torch.bfloat16])
    if not ok:
        raise AssertionError(f"flash_attention_fwd smollm shape: max "
                             f"|kernel-plain| {err}")
    log(f"[kernel] smollm shape {shape} bf16: max |kernel-plain| {err:.3g}")
    return err


def smoke_params(cfg, seed):
    """``init_params`` with wq, wk and wv rescaled to fan_in = d_model.

    The reference's init takes fan_in = shape[-2] for these (d, H, hd)
    weights, the head count (src/repro/models/transformer.py:153), so at
    full width the scores have a std near 100 and every softmax is a hard
    argmax.  Such a model is chaotic: a perturbation at the level of float32
    rounding in one attention output flips argmaxes downstream and moves the
    last-token logits by as much as their own size
    (tools/prefill_sensitivity.py measures it).  With fan_in = d_model the
    same perturbation stays at the level of rounding, so the comparisons
    below can tell a fault from rounding.  The path the weights take is
    unchanged.
    """
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, seed, device="cuda")
    for layer in params["layers"]:
        if "wq" not in layer["mixer"]:          # a mamba layer (jamba)
            continue
        for name in ("wq", "wk", "wv"):
            w = layer["mixer"][name]
            w.mul_((w.shape[-2] / w.shape[0]) ** 0.5)
    return params


def mamba_smoke_params(cfg, seed):
    """``init_params`` with each layer's dt_bias and A_log drawn as Mamba2's
    published init draws them (``mamba_ssm``: dt log-uniform in [1e-3, 0.1],
    A uniform in [1, 16]; ``tools.mamba_sensitivity.published_dt_a``).

    The reference draws both uniform in [0.5, 1.5)
    (src/repro/models/transformer.py:152), so dt is about 1.3 and each step
    decays the state by about e^-3.5.  At those values the bf16 model turns
    a change of one f32 ulp in y_intra into a change of about 0.18 in its
    last-token logits, as much as kernel and plain routes differ
    (tools/mamba_sensitivity.py, "nudged").  With the published values that
    floor is about 0.05, so the comparison below can tell a fault from
    rounding, and the whole chunk, not only the last token or two, reaches
    y_intra.  The path the weights take is unchanged.
    """
    from repro_torch.models import transformer as T
    from tools.mamba_sensitivity import published_dt_a
    return published_dt_a(T.init_params(cfg, 0, device="cuda"), seed)


def plain_route(q, k, v, **kw):
    """``ops.flash_attention`` through the kernel's plain version."""
    from repro_torch.kernels.ref import attention_reference
    return attention_reference(q, k, v, causal=kw["causal"],
                               window=kw["window"],
                               attn_softcap=kw["attn_softcap"])


def check_flash(got, want, what):
    """``check_fwd`` on o; returns (max |kernel - plain|, normwise)."""
    r = check_fwd(what, got, want)
    return r["o"], r["normwise"]


# K1 on a prefill path (``phase_prefill``'s routes)
FLASH_ROUTE = ("flash_attention", plain_route, check_flash,
               f"{TOL[torch.bfloat16]} abs + rel, normwise "
               f"{FWD_NORM_TOL[torch.bfloat16]}")


def prefill_with(routes, prefill, params, batch):
    """Run ``prefill`` with ``ops.<name>`` replaced by ``routes[name]``."""
    from repro_torch.kernels import ops
    saved = {name: getattr(ops, name) for name in routes}
    for name, route in routes.items():
        setattr(ops, name, route)
    try:
        return prefill(params, batch)
    finally:
        for name, route in saved.items():
            setattr(ops, name, route)


@contextlib.contextmanager
def moe_routes(record=None, replay=None):
    """``repro_torch.models.moe._route`` patched: each MoE layer's expert
    choices (G, T, k) are appended to ``record``, or taken, in call order,
    from ``replay``, with the gates and aux recomputed from this route's
    own router probabilities at those choices.  Without either it changes
    nothing."""
    from repro_torch.models import moe
    real = moe._route
    replayed = None if replay is None else iter(replay)

    def route(x, router_w, cfg):
        if replayed is not None:
            return moe._gates_at(moe._router_probs(x, router_w),
                                 next(replayed), cfg.num_experts)
        out = real(x, router_w, cfg)
        if record is not None:
            record.append(out[1])
        return out
    moe._route = route
    try:
        yield
    finally:
        moe._route = real


def dropped(cfg, idxs):
    """Assignments past their expert's capacity, summed over the MoE calls
    whose choices are ``idxs``, and all assignments."""
    from repro_torch.models import moe
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    n = total = 0
    for idx in idxs:
        C = moe._capacity(idx.shape[1], K, E, cfg.capacity_factor)
        n += int((moe._positions(idx, E, C) >= C).sum())
        total += idx.numel()
    return n, total


def expected_launches(cfg, train=False):
    """A prefill's launches: K1 once per attention layer, K2 and K3 once
    per mamba layer, nothing else.  With ``train``, one loss-and-grad under
    remat "full": K1, K2 and K3 twice per layer of their kind (the forward
    and its recompute in the backward), K1b, K2b and K3b once."""
    from repro_torch.models import transformer as T
    n_attn = sum(kind in ("attn", "local_attn")
                 for kind, _ in T.layer_program(cfg))
    n_ssd = cfg.num_layers - n_attn
    if train:
        return {"flash_attention_fwd": 2 * n_attn,
                "flash_attention_bwd": n_attn, "ssd_chunk_kernel": 2 * n_ssd,
                "ssd_chunk_bwd_kernel": n_ssd, "ssd_pass_kernel": 2 * n_ssd,
                "ssd_pass_bwd_kernel": n_ssd}
    return {"flash_attention_fwd": n_attn, "flash_attention_bwd": 0,
            "ssd_chunk_kernel": n_ssd, "ssd_chunk_bwd_kernel": 0,
            "ssd_pass_kernel": n_ssd, "ssd_pass_bwd_kernel": 0}


def param_count(params):
    from repro_torch.tree import leaves
    return sum(t.numel() for t in leaves(params))


def phase_lse_vs_plain():
    """K1 writing its lse against ``flash_attention_lse_plain`` over the
    sweep grid and smollm's shape; its o equal to the call without lse."""
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_lse_plain)
    worst = {}
    for shape, window, cap in sweep_cases([TRAIN_SHAPE]):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = qkv(shape, dtype, seed=4)
            kw = dict(causal=True, window=window, attn_softcap=cap)
            o, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
            torch.cuda.synchronize()
            want_o, want_lse = flash_attention_lse_plain(q, k, v, **kw)
            for name, got, want in (("o", o, want_o),
                                    ("lse", lse, want_lse)):
                err, ok = max_excess(got, want, TOL[dtype])
                if not ok:
                    raise AssertionError(
                        f"flash_attention_fwd lse {shape} {dtype} window="
                        f"{window} cap={cap}: {name} max |kernel-plain| "
                        f"{err} over tol {TOL[dtype]}")
                worst[name, dtype] = max(worst.get((name, dtype), 0.0), err)
            if not torch.equal(o, flash_attention_fwd(q, k, v, **kw)):
                raise AssertionError(f"flash_attention_fwd {shape} {dtype}:"
                                     " o differs with and without lse")
    log(f"[kernel] flash_attention_fwd with lse, sweep, no-key shapes and "
        f"{TRAIN_SHAPE}: "
        + ", ".join(f"{n} {dt} max |kernel-plain| {e:.3g}"
                    for (n, dt), e in worst.items()))
    return max(worst.values())


def phase_bwd_vs_plain():
    """K1b against ``flash_attention_bwd_plain`` on the same (q, k, v, o,
    lse, do), o and lse from K1, over the sweep grid, the no-key shapes,
    the training shape and the D=128 shape, elementwise and normwise;
    every call twice, bitwise equal."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_fwd)
    worst = {}
    for shape, window, cap in sweep_cases([TRAIN_SHAPE, D128_SHAPE]):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = qkv(shape, dtype, seed=5)
            do = qkv(shape, dtype, seed=6)[0]
            kw = dict(causal=True, window=window, attn_softcap=cap)
            o, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
            got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
            again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
            for name, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
                if not torch.equal(g, g2):
                    raise AssertionError(f"flash_attention_bwd {shape} "
                                         f"{dtype}: {name} differs between "
                                         "two runs")
                err, ok = max_excess(g, w, BWD_TOL[dtype])
                rel = norm_error(g, w)
                if not (ok and rel <= BWD_NORM_TOL[dtype]
                        and bool(torch.isfinite(g).all())):
                    raise AssertionError(
                        f"flash_attention_bwd {shape} {dtype} window="
                        f"{window} cap={cap}: {name} max |kernel-plain| "
                        f"{err} (tol {BWD_TOL[dtype]}), normwise {rel} "
                        f"(tol {BWD_NORM_TOL[dtype]})")
                key = ({TRAIN_SHAPE: "training shape",
                        D128_SHAPE: "D=128 shape"}.get(shape, "sweep"), dtype)
                e0, r0 = worst.get(key, (0.0, 0.0))
                worst[key] = (max(e0, err), max(r0, rel))
    log(f"[kernel] flash_attention_bwd, {len(SWEEP)} sweep shapes x 4 "
        f"window/cap, the no-key shapes, {TRAIN_SHAPE} and {D128_SHAPE}, "
        "f32/bf16, dq dk dv, each run twice and bitwise equal: "
        + ", ".join(f"{k} {dt} max |kernel-plain| {e:.3g}, normwise {r:.3g}"
                    for (k, dt), (e, r) in worst.items())
        + f" (tol {BWD_TOL[torch.float32]} f32, {BWD_TOL[torch.bfloat16]} "
        f"bf16, abs + rel; normwise {BWD_NORM_TOL[torch.float32]} f32, "
        f"{BWD_NORM_TOL[torch.bfloat16]} bf16)")
    return max(e for e, _ in worst.values())


def phase_no_key_rows():
    """Rows that see no key, on the card (NOKEY_SHAPES: at D = 64, 128
    and 256 through K1's and K1b's wgmma kernels): K1 writes o = 0 there,
    with and without its lse, and lse = -1e30; K1b gives them dq = 0,
    and a nonzero do on those rows leaves dk and dv bitwise as they are
    with do = 0 there (p = 0 and ds = 0 on all their entries)."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    from repro_torch.kernels.ref import NEG_INF
    n = 0
    for shape in NOKEY_SHAPES:
        seen = shape[2] + NOKEY_WINDOW - 1      # rows from here see no key
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = qkv(shape, dtype, seed=9)
            do = qkv(shape, dtype, seed=10)[0]
            quiet = do.clone()
            quiet[:, seen:] = 0
            for cap in (0.0, 30.0):
                kw = dict(causal=True, window=NOKEY_WINDOW, attn_softcap=cap)
                o, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
                o_serve = flash_attention_fwd(q, k, v, **kw)
                loud = flash_attention_bwd(q, k, v, o, lse, do, **kw)
                calm = flash_attention_bwd(q, k, v, o, lse, quiet, **kw)
                torch.cuda.synchronize()
                checks = {
                    "o = 0": bool((o[:, seen:] == 0).all()
                                  and (o_serve[:, seen:] == 0).all()),
                    "lse = -1e30": bool((lse[:, seen:] == NEG_INF).all()
                                        and (lse[:, :seen] > -1e3).all()),
                    "dq = 0": bool((loud[0][:, seen:] == 0).all()),
                    "dk, dv unchanged": (torch.equal(loud[1], calm[1])
                                         and torch.equal(loud[2], calm[2])),
                }
                if not all(checks.values()):
                    raise AssertionError(f"rows without a key, {shape} {dtype}"
                                         f" cap={cap}: {checks}")
                n += 1
    log(f"[kernel] rows that see no key, {NOKEY_SHAPES} window "
        f"{NOKEY_WINDOW}, f32/bf16, cap 0/30 ({n} cases): K1 o = 0 and lse = "
        "-1e30 there, K1b dq = 0 there and dk, dv bitwise unchanged by a "
        "nonzero do on those rows")


def phase_d256():
    """K1 (o and lse) and K1b at gemma2-9b's attention shape against their
    plain versions, bf16 and f32, with the 4096 window and without, cap
    50: K1 by ``check_fwd``, K1b within BWD_TOL and BWD_NORM_TOL, run
    twice and bitwise equal; every call launches its kernel."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_fwd,
                                                     flash_attention_lse_plain)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = qkv(GEMMA_SHAPE, dtype, seed=15)
        do = qkv(GEMMA_SHAPE, dtype, seed=16)[0]
        for window in (GEMMA_WINDOW, 0):
            kw = dict(causal=True, window=window, attn_softcap=GEMMA_CAP)
            f0, b0 = flash_attention_fwd.launches, flash_attention_bwd.launches
            o, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
            got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
            again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            if (flash_attention_fwd.launches - f0,
                    flash_attention_bwd.launches - b0) != (1, 2):
                raise AssertionError("D=256: a call did not launch its kernel")
            what = (f"D=256 {GEMMA_SHAPE} {dtype} window={window} "
                    f"cap={GEMMA_CAP}")
            want_o, want_lse = flash_attention_lse_plain(q, k, v, **kw)
            r = check_fwd(what, o, want_o, lse, want_lse)
            w0 = worst.get(("fwd", dtype), (0.0, 0.0, 0.0))
            worst["fwd", dtype] = tuple(
                max(a, r[key]) for a, key in zip(w0, ("o", "normwise", "lse")))
            del want_o, want_lse
            want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
            for name, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
                err, ok = max_excess(g, w, BWD_TOL[dtype])
                rel = norm_error(g, w)
                if not torch.equal(g, g2):
                    raise AssertionError(f"flash_attention_bwd {what}: {name} "
                                         "differs between two runs")
                if not (ok and rel <= BWD_NORM_TOL[dtype]
                        and bool(torch.isfinite(g).all())):
                    raise AssertionError(
                        f"flash_attention_bwd {what}: {name} max "
                        f"|kernel-plain| {err} (tol {BWD_TOL[dtype]}), "
                        f"normwise {rel} (tol {BWD_NORM_TOL[dtype]})")
                e0, r0 = worst.get(("bwd", dtype), (0.0, 0.0))
                worst["bwd", dtype] = (max(e0, err), max(r0, rel))
            del want, got, again
            torch.cuda.empty_cache()
    log(f"[kernel] head dim 256, gemma2-9b attention {GEMMA_SHAPE} cap "
        f"{GEMMA_CAP}, window {GEMMA_WINDOW} and none, f32/bf16, K1 o and "
        "lse, K1b dq dk dv each run twice and bitwise equal: "
        + ", ".join(f"{k} {dt} max |kernel-plain| "
                    + (f"{e[0]:.3g}, normwise {e[1]:.3g}" if k == "bwd"
                       else f"o {e[0]:.3g}, normwise {e[1]:.3g}, lse "
                       f"{e[2]:.3g}")
                    for (k, dt), e in worst.items())
        + f" (K1: tol {TOL[torch.float32]} f32, {TOL[torch.bfloat16]} bf16, "
        f"abs + rel; o normwise {FWD_NORM_TOL[torch.float32]} f32, "
        f"{FWD_NORM_TOL[torch.bfloat16]} bf16; lse {LSE_TOL} abs)")
    return {"fwd": max(max(e[0], e[2]) for (k, _), e in worst.items()
                       if k == "fwd"),
            "bwd": max(e[0] for (k, _), e in worst.items() if k == "bwd")}


def phase_d256_timings(card):
    """K1 and K1b (bf16) at gemma2-9b's attention shape with no window (a
    global layer), with its cap 50 and with none, beside SDPA's forward and
    backward at the same shape (causal, no cap: SDPA has none, so the cap-0
    rows are like for like), in turns; and the plain versions at cap 50."""
    import torch.nn.functional as F
    from repro_torch.kernels.cost import flash_bwd_cost, flash_fwd_cost
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_fwd,
                                                     flash_attention_plain)
    q, k, v = qkv(GEMMA_SHAPE, torch.bfloat16, seed=17)
    do = qkv(GEMMA_SHAPE, torch.bfloat16, seed=18)[0]
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    lib_fwd = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    out = lib_fwd()
    dot = do.transpose(1, 2)
    lib_bwd = lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                          retain_graph=True)
    res = {}
    for cap in (GEMMA_CAP, 0.0):
        kw = dict(causal=True, attn_softcap=cap)
        o, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
        fwd = lambda: flash_attention_fwd(q, k, v, **kw)
        bwd = lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw)
        for name, kern, lib, plain, products, (flops, nbytes) in (
                ("fwd", fwd, lib_fwd,
                 lambda: flash_attention_plain(q, k, v, **kw), 2,
                 flash_fwd_cost(q, k, causal=True)),
                ("bwd", bwd, lib_bwd,
                 lambda: flash_attention_bwd_plain(q, k, v, o, lse, do, **kw),
                 5, flash_bwd_cost(q, k, causal=True))):
            t_k, t_l = in_turns(kern, lib, iters=10)
            bound_ms, bound_by = bound(flops, nbytes)
            ms = sum(t_k) / 2
            row = {"ms": ms, "library_ms": sum(t_l) / 2,
                   "bound_ms": bound_ms, "bound_by": bound_by}
            if cap:
                row["plain_ms"] = cuda_ms(plain, iters=2, warmup=1)
                torch.cuda.empty_cache()
            res[name if cap else f"{name}_cap0"] = row
            log(f"[timing] {card}: flash_attention_{name} D=256 {GEMMA_SHAPE} "
                f"bf16 causal cap {cap}: {t_k[0]:.4f} / {t_k[1]:.4f} ms; "
                f"{flops / 1e9:.3f} GFLOP ({products} products), "
                f"{nbytes / 1e6:.2f} MB; bound {bound_ms:.4f} ms "
                f"({bound_by}), {100 * bound_ms / ms:.2f}% of bound; "
                + (f"plain {row['plain_ms']:.4f} ms; " if cap else "")
                + f"scaled_dot_product_attention {name} (causal, no cap) "
                f"{t_l[0]:.4f} / {t_l[1]:.4f} ms (in turns: kernel, library, "
                "library, kernel)")
    return res


def train_batch(cfg, B, S, seed):
    """Tokens, next-token targets and a full loss mask, on the card."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S + 1))
    return {"tokens": torch.from_numpy(toks[:, :-1]).cuda(),
            "targets": torch.from_numpy(toks[:, 1:]).cuda(),
            "loss_mask": torch.ones((B, S), device="cuda")}


def route_compare(what, cfg, params, batch, plain):
    """One loss and grad by the kernel route, its launches counted (one
    ``expected_launches(cfg, train=True)``), against the plain route: each
    ``ops.<name>`` replaced by ``plain[name]``, as ``prefill_with`` replaces
    ``ops.flash_attention``; the plain route launches nothing.  Each MoE
    call's expert choices are recorded on the kernel route, in call order
    (under remat "full" a layer's forward and its recompute in the
    backward), and replayed on the plain route.  Loss within
    ROUTE_LOSS_TOL, every grad leaf within ROUTE_GRAD_TOL of its largest
    magnitude."""
    from repro_torch import params as P
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.tree import leaves
    loss_and_grad = M.make_loss_and_grad(cfg)
    idxs = []
    with moe_routes(record=idxs):
        reset_launches()
        grads, metrics = loss_and_grad(params, batch)
        torch.cuda.synchronize()
        counts = read_launches()
    want = expected_launches(cfg, train=True)
    if counts != want:
        raise AssertionError(f"{what} train route launched {counts}, "
                             f"expected {want}")
    saved = {name: getattr(ops, name) for name in plain}
    for name, fn in plain.items():
        setattr(ops, name, fn)
    try:
        with moe_routes(replay=idxs if cfg.num_experts else None):
            reset_launches()
            pgrads, pmetrics = loss_and_grad(params, batch)
            torch.cuda.synchronize()
            if any(read_launches().values()):
                raise AssertionError(f"{what} plain route launched "
                                     f"{read_launches()}")
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)
    loss_err = abs(float(metrics["loss"]) - float(pmetrics["loss"]))
    worst = 0.0
    for g, w in zip(leaves(P.stack_layers(grads, cfg)),
                    leaves(P.stack_layers(pgrads, cfg))):
        scale = float(w.abs().max())
        if not (bool(torch.isfinite(g).all()) and scale > 0):
            raise AssertionError(f"{what} train route: a grad leaf is not "
                                 "finite or is zero on the plain route")
        worst = max(worst, float((g - w).abs().max()) / scale)
    log(f"[train] {what}, loss and grad, kernel route vs plain route"
        + (f" ({len(idxs)} MoE calls' expert choices replayed)"
           if cfg.num_experts else "")
        + f": loss {float(metrics['loss']):.6f} vs "
        f"{float(pmetrics['loss']):.6f} (|diff| {loss_err:.3g}, tol "
        f"{ROUTE_LOSS_TOL}); every grad leaf within {worst:.3g} of its "
        f"largest magnitude (tol {ROUTE_GRAD_TOL}); launches {counts}")
    if not (loss_err <= ROUTE_LOSS_TOL and worst <= ROUTE_GRAD_TOL):
        raise AssertionError(f"{what} train route: kernel and plain routes "
                             "disagree")
    return {"loss_err": loss_err, "grad_rel_err": worst, "launches": counts}


def phase_train_routes():
    """One loss and grad of smollm-360m at full width, cut to 4 layers, f32,
    B=2, S=256, with ``smoke_params``: kernel route (K1 with lse, K1b)
    against the plain route (``route_compare``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ref import (flash_attention_bwd_plain,
                                         flash_attention_lse_plain)
    cfg = dataclasses.replace(get_config("smollm-360m"), dtype="float32",
                              num_layers=ROUTE_LAYERS)
    return route_compare(
        f"smollm-360m f32 {ROUTE_LAYERS} layers B={ROUTE_B} S={ROUTE_S}", cfg,
        smoke_params(cfg, 11), train_batch(cfg, ROUTE_B, ROUTE_S, 12),
        {"flash_attention_lse": flash_attention_lse_plain,
         "flash_attention_grads": flash_attention_bwd_plain})


def ssd_cotangents(shape, seed):
    """f32 cotangents of the four chunk terms at ``shape``."""
    B, S, H, P, N, Q = shape
    nc = S // Q
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, np.float32)).cuda()
            for s in ((B, S, H, P), (B, H, nc, P, N), (B, H, nc, Q), (B, H, nc))]


def published_ssd_inputs(shape, dtype, seed):
    """``ssd_inputs`` at the model's scale with dt and A as Mamba2's
    published init gives them (``tools.mamba_sensitivity.published_dt_a``):
    dt = softplus(u + dt_bias), dt_bias the inverse softplus of a
    log-uniform draw in [1e-3, 0.1], A = -U(1, 16).  A 256-long chunk's
    decay then passes 88 by far: exp(cum_i - cum_j) above the diagonal is
    inf in f32."""
    import torch.nn.functional as F
    B, S, H, P, N, _ = shape
    x, _, _, B_, C_ = ssd_inputs(shape, dtype, seed)
    rng = np.random.default_rng(seed + 1)
    dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), H))
    bias = torch.from_numpy((dt0 + np.log(-np.expm1(-dt0))).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((B, S, H), np.float32))
    dt = F.softplus(u + bias).cuda()
    A = -torch.from_numpy(rng.uniform(1, 16, H).astype(np.float32)).cuda()
    return x, dt, A, B_, C_


def check_rounded(got, want, tol, norm_tol):
    """For an output rounded once to bf16 (got) from an f32 sum the plain
    version computes as want: each element is the bf16 rounding of some
    value within atol=rtol=tol of want (its rounding interval meets want's
    tolerance), and ||got - want|| is within norm_tol ||want|| of what
    rounding want itself gives, ||bf16(want) - want||.  Returns (largest
    |got - want| beyond half a bf16 spacing, whether the elementwise check
    holds, the normwise excess over the rounding's own error)."""
    g, want = got.float(), want.float()
    m, e = torch.frexp(g)
    half = torch.ldexp(torch.ones_like(g), e - 9)     # half a bf16 spacing
    # below a power of two the spacing toward zero is half as large
    half = torch.where((m.abs() == 0.5) & (want.abs() < g.abs()), half / 2,
                       half)
    half = torch.where(g == 0, torch.zeros_like(g), half)
    over = ((g - want).abs() - half).clamp(min=0)
    ok = bool((over <= tol + tol * want.abs()).all())
    rounding = (want.to(torch.bfloat16).float() - want).norm()
    rel = float(((g - want).norm() - rounding) / want.norm())
    return float(over.max()), ok and rel <= norm_tol, rel


def check_ssd_grads(got, again, want, what, dx32=None):
    """Each gradient finite, bitwise equal over two runs, within SSD_TOL
    elementwise and SSD_BWD_NORM_TOL normwise of the plain version (dx in
    bf16 through ``check_rounded`` against dx32, the plain version's f32
    sum); returns (largest |kernel - plain|, largest normwise error)."""
    worst = (0.0, 0.0)
    for name, g, g2, w in zip(SSD_GRADS, got, again, want):
        if not torch.equal(g, g2):
            raise AssertionError(f"ssd_chunk_bwd_kernel {what}: {name} "
                                 "differs between two runs")
        if g.shape != w.shape or g.dtype != w.dtype \
                or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"ssd_chunk_bwd_kernel {what}: {name} "
                                 f"{g.dtype} {tuple(g.shape)} not finite or "
                                 "misshapen")
        if name == "dx" and g.dtype == torch.bfloat16:
            err, ok, rel = check_rounded(g, dx32, SSD_TOL, SSD_BWD_NORM_TOL)
        else:
            err, ok = max_excess(g, w, SSD_TOL)
            rel = norm_error(g, w)
            ok = ok and rel <= SSD_BWD_NORM_TOL
        if not ok:
            raise AssertionError(
                f"ssd_chunk_bwd_kernel {what}: {name} max |kernel-plain| "
                f"{err} (tol {SSD_TOL}), normwise {rel} (tol "
                f"{SSD_BWD_NORM_TOL})")
        worst = (max(worst[0], err), max(worst[1], rel))
    return worst


def phase_ssd_bwd_vs_plain():
    """K2b against ``ssd_chunk_bwd_plain`` on the same inputs and
    cotangents over the sweep and the mamba2 shape, f32 and bf16, then at
    the mamba2 shape with the published dt/A draw (the plain version masks
    the log-decay before its exp there); every call twice, bitwise equal.
    Then the gradients of ``ops.ssd`` (K2, K2b and the recurrence between
    chunks) from a nonzero h0 against autograd through ``ssd_sequential``,
    dh0 included."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_sequential
    from repro_torch.kernels.ssd import (ssd_chunk_bwd_kernel,
                                         ssd_chunk_bwd_plain, ssd_chunk_kernel)
    from repro_torch.kernels.ssd import ssd_route
    worst = {}
    cases = ([(shape, dtype, ssd_inputs) for shape in SSD_SWEEP + [MAMBA_SHAPE]
              for dtype in (torch.float32, torch.bfloat16)]
             + [(MAMBA_SHAPE, torch.bfloat16, published_ssd_inputs)]
             + [(shape, torch.bfloat16, ssd_inputs)
                for shape, _ in SSD_ROUTE_SHAPES])
    routes = dict(SSD_ROUTE_SHAPES)
    for shape, dtype, inputs in cases:
        args = inputs(shape, dtype, seed=40)
        if dtype == torch.bfloat16 and shape in routes and ssd_route(
                args[0], args[3], args[4], shape[-1]) != routes[shape]:
            raise AssertionError(f"ssd_route {shape}: not {routes[shape]}")
        cts = ssd_cotangents(shape, seed=41)
        got = ssd_chunk_bwd_kernel(*args, *cts, chunk=shape[-1])
        again = ssd_chunk_bwd_kernel(*args, *cts, chunk=shape[-1])
        torch.cuda.synchronize()
        want = ssd_chunk_bwd_plain(*args, *cts, chunk=shape[-1])
        # the same function on the inputs upcast (exactly) to f32: dx's f32
        # sum before its one rounding
        dx32 = ssd_chunk_bwd_plain(*(t.float() for t in args), *cts,
                                   chunk=shape[-1])[0]
        key = ((f"{shape} {routes[shape]}" if shape in routes
                else "sweep" if shape != MAMBA_SHAPE else "mamba2 shape"
                if inputs is ssd_inputs else "mamba2 shape, published dt/A"),
               dtype)
        e, r = check_ssd_grads(got, again, want, f"{key[0]} {shape} {dtype}",
                               dx32)
        e0, r0 = worst.get(key, (0.0, 0.0))
        worst[key] = (max(e0, e), max(r0, r))
        del got, again, want, dx32
    log(f"[kernel] ssd_chunk_bwd_kernel, {len(SSD_SWEEP)} sweep shapes and "
        f"the mamba2 shape {MAMBA_SHAPE} x f32/bf16, the mamba2 shape "
        "with the published dt/A draw, and the bf16 route shapes (P = 128 "
        "and the edge between the wgmma and mma.sync routes), dx ddt dA dB "
        "dC each run twice and bitwise equal: "
        + ", ".join(f"{k} {dt} max |kernel-plain| {e:.3g}, normwise {r:.3g}"
                    for (k, dt), (e, r) in worst.items())
        + f" (tol {SSD_TOL} abs + rel, normwise {SSD_BWD_NORM_TOL}; bf16 dx "
        "through its one rounding)")
    # the scan's gradients, from a nonzero state, against the recurrence
    shape = (2, 64, 4, 16, 8, 16)
    rng = np.random.default_rng(42)
    ins = [t.detach().requires_grad_()
           for t in ssd_inputs(shape, torch.float32, seed=43)]
    h0 = torch.from_numpy(rng.standard_normal((2, 4, 16, 8), np.float32)
                          ).cuda().requires_grad_()
    cts = [torch.from_numpy(rng.standard_normal(s, np.float32)).cuda()
           for s in ((2, 64, 4, 16), (2, 4, 16, 8))]
    k0, b0 = ssd_chunk_kernel.launches, ssd_chunk_bwd_kernel.launches
    got = torch.autograd.grad(ops.ssd(*ins, shape[-1], h0=h0), ins + [h0], cts)
    torch.cuda.synchronize()
    if (ssd_chunk_kernel.launches - k0, ssd_chunk_bwd_kernel.launches - b0) \
            != (1, 1):
        raise AssertionError("ops.ssd's forward and backward did not launch "
                             "K2 and K2b once each")
    want = torch.autograd.grad(ssd_sequential(*ins, h0=h0), ins + [h0], cts)
    errs = {}
    for name, g, w in zip(SSD_GRADS + ("dh0",), got, want):
        errs[name], ok = max_excess(g, w, SSD_TOL)
        if not (ok and bool(torch.isfinite(g).all())):
            raise AssertionError(f"ops.ssd backward {shape}: {name} max "
                                 f"|kernel-sequential| {errs[name]} over tol "
                                 f"{SSD_TOL}")
    log(f"[kernel] ops.ssd backward {shape} f32 from a nonzero h0 (K2, K2b "
        "and the recurrence by autograd) vs autograd through "
        "ssd_sequential: "
        + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
        + f" (tol {SSD_TOL})")
    return max(e for e, _ in worst.values())


def phase_mamba_train_route():
    """mamba2-1.3b at full width cut to 4 layers, f32, B=2, S=512 (two
    chunks), ``mamba_smoke_params``: loss and grad by the kernel route (K2
    and K3 twice per layer, K2b and K3b once) against the plain route,
    ``ops.ssd_chunk``, ``ops.ssd_pass`` and their gradients replaced by
    their plain versions."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(MAMBA), dtype="float32",
                              num_layers=MAMBA_ROUTE_LAYERS)
    out = route_compare(
        f"{MAMBA} f32 {MAMBA_ROUTE_LAYERS} layers B={MAMBA_ROUTE_B} "
        f"S={MAMBA_ROUTE_S}", cfg, mamba_smoke_params(cfg, 44),
        train_batch(cfg, MAMBA_ROUTE_B, MAMBA_ROUTE_S, 45),
        ssd_plain_routes())
    gc.collect()
    torch.cuda.empty_cache()
    return out


def timed_steps(step, params, state, batch, steps):
    """Run ``steps`` train steps on one batch, each timed by CUDA events
    with its launches counted from 0: (params, state, losses, metrics of
    the last step, ms per step, launches per step)."""
    losses, times, counts = [], [], []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reset_launches()                        # the main path starts here
        start.record()
        params, state, metrics = step(params, state, batch)
        end.record()
        end.synchronize()
        counts.append(read_launches())          # ... and ends here
        times.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
    return params, state, losses, metrics, times, counts


def phase_mamba_train(card):
    """A main path: ``make_train_step`` on mamba2-1.3b at full width, bf16,
    B=8, S=1024, remat "full", AdamW, 5 steps on one batch, with
    ``mamba_smoke_params`` (the published dt/A draw: every chunk's decay
    passes 88, where the reference's backward gives NaN).  Each step: K2 and
    K3 96 launches each (the forward and its recompute), K2b and K3b 48,
    nothing else; the
    loss finite every step and lower at step 5 than at step 1.  Then the
    train driver (``repro_torch.launch.train.main``) on the same arch, 2
    segments of 2 steps through the runtime, launches counted around the
    run and inside each segment's body."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.optim import AdamW, cosine_schedule
    cfg = get_config(MAMBA)
    params = mamba_smoke_params(cfg, 46)
    n = param_count(params)
    opt = AdamW(lr=cosine_schedule(3e-4, 1, 10_000))
    state = opt.init(params)
    batch = train_batch(cfg, PREFILL_B, PREFILL_S, 47)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, state, losses, metrics, times, counts = timed_steps(
        M.make_train_step(cfg, opt), params, state, batch, MAMBA_TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    want = expected_launches(cfg, train=True)
    step_ms = sum(times[1:]) / (len(times) - 1)
    tok_s = PREFILL_B * PREFILL_S / (step_ms / 1e3)
    log(f"[train] {MAMBA} ({n} params) bf16 B={PREFILL_B} S={PREFILL_S} remat "
        f"{cfg.remat}, {MAMBA_TRAIN_STEPS} steps on one batch: losses "
        f"{losses}, grad norm at the last {float(metrics['grad_norm']):.4g}; "
        f"launches per step {counts[0]} (expected {want}); step ms "
        + ", ".join(f"{t:.3f}" for t in times)
        + f" (mean after the first {step_ms:.3f}, {tok_s:.0f} tokens/s); peak "
        f"{peak / 2**30:.3f} GiB ({card})")
    if any(c != want for c in counts):
        raise AssertionError(f"{MAMBA} train steps launched {counts}, "
                             f"expected {want} each")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{MAMBA} train losses {losses}: not finite or "
                             "not falling")
    del params, state, batch, metrics
    gc.collect()
    torch.cuda.empty_cache()

    driver = driver_run(cfg, MAMBA_TRAIN_ARGV, "chip_smoke_ckpt_mamba",
                        "ssd_chunk_bwd_kernel")
    return {"losses": losses, "launches": sum(c["ssd_chunk_bwd_kernel"]
                                              for c in counts),
            "per_step": counts[0], "step_ms": step_ms, "times": times,
            "tok_s": tok_s, "peak_bytes": peak, "params": n,
            "driver": driver}


def driver_run(cfg, argv, ckpt_name, bwd):
    """A main path: ``repro_torch.launch.train.main`` with ``argv`` (4 steps
    in 2 segments through the runtime, one evaluation, a checkpoint under
    build/``ckpt_name``), counts set to 0 just before it and read just
    after: each forward kernel twice per layer of its kind and step
    (forward and recompute) and once more per layer for the evaluation,
    each backward once per layer and step; inside each train_segment
    body ``bwd`` once per layer and step."""
    from repro_torch.launch import train
    ckpt = ROOT / "build" / ckpt_name
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        reset_launches()                        # the main path starts here
        rec = {}
        losses = train.main(argv + ["--ckpt-dir", str(ckpt)], rec)
        torch.cuda.synchronize()
        counts = read_launches()                # ... and ends here
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    step, evaluation = expected_launches(cfg, train=True), expected_launches(cfg)
    want = {k: 4 * step[k] + evaluation[k] for k in step}
    tasks = segment_tasks(rec)
    log(f"[train] {cfg.name} driver, 4 steps in 2 segments through the "
        f"runtime: losses {losses}, launches {counts} (expected {want}), "
        f"{seconds:.1f}s with a checkpoint; peak after each segment "
        + ", ".join(f"{s['peak_bytes'] / 2**30:.3f}" for s in rec["segments"])
        + " GiB; launches inside each train_segment body "
        + ", ".join(str(t["launches"]) for t in tasks))
    if counts != want or len(losses) != 2 or not all(np.isfinite(losses)):
        raise AssertionError(f"{cfg.name} driver: losses {losses}, launches "
                             f"{counts}, expected {want}")
    for t in tasks:
        if t["launches"][bwd] != step[bwd] * sum(t["steps"]):
            raise AssertionError(f"{cfg.name} driver: {t['uid']} launched "
                                 f"{t['launches']} inside its body")
    return {"losses": losses, "counts": counts, "seconds": seconds,
            "tasks": tasks}


def phase_jamba_train_route():
    """jamba-1.5-large-398b at its reduced config, f32, B=2, S=256 (32 SSD
    chunks of 8), attention rescaled as ``smoke_params`` does and dt, A
    drawn as Mamba2's published init draws them: loss and grad by the
    kernel route (K1 with lse and K1b in its 2 attention layers, K2, K3,
    K2b and K3b in its 14 mamba layers) against the plain route with every kernel
    replaced, the expert choices of each MoE call replayed."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.kernels.ref import (flash_attention_bwd_plain,
                                         flash_attention_lse_plain)
    from tools.mamba_sensitivity import published_dt_a
    cfg = dataclasses.replace(reduce_config(get_config(JAMBA)), dtype="float32")
    return route_compare(
        f"{JAMBA} reduced f32 B={ROUTE_B} S={ROUTE_S}", cfg,
        published_dt_a(smoke_params(cfg, 48), 48),
        train_batch(cfg, ROUTE_B, ROUTE_S, 49),
        {"flash_attention_lse": flash_attention_lse_plain,
         "flash_attention_grads": flash_attention_bwd_plain,
         **ssd_plain_routes()})


def phase_qwen_train(card):
    """qwen3-moe-235b-a22b at full width cut to 1 of its 94 layers, bf16,
    B=8, S=1024, ``smoke_params``: one loss and grad (loss, aux and every
    grad leaf finite; K1 twice, K1b once, nothing else), then
    ``make_train_step`` with AdamW, 3 steps on one batch, timed, with the
    device's peak."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(get_config(QWEN), num_layers=QWEN_TRAIN_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    params = smoke_params(cfg, 50)
    n = param_count(params)
    batch = train_batch(cfg, PREFILL_B, PREFILL_S, 51)
    want = expected_launches(cfg, train=True)
    reset_launches()
    grads, metrics = M.make_loss_and_grad(cfg)(params, batch)
    torch.cuda.synchronize()
    counts = read_launches()
    finite = all(bool(torch.isfinite(g).all()) for g in leaves(grads))
    del grads
    if counts != want or not finite or not all(
            np.isfinite(float(metrics[k])) for k in ("loss", "aux")):
        raise AssertionError(f"{QWEN} loss and grad: launches {counts} "
                             f"(expected {want}), grads finite {finite}, "
                             f"metrics {metrics}")
    opt = AdamW(lr=cosine_schedule(3e-4, 1, 10_000))
    state = opt.init(params)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, state, losses, last, times, step_counts = timed_steps(
        M.make_train_step(cfg, opt), params, state, batch, QWEN_TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    step_ms = sum(times[1:]) / (len(times) - 1)
    log(f"[train] {QWEN} at full width, {QWEN_TRAIN_LAYERS} of "
        f"{get_config(QWEN).num_layers} layers ({n} params), bf16 "
        f"B={PREFILL_B} S={PREFILL_S}: loss {float(metrics['loss']):.5f}, aux "
        f"{float(metrics['aux']):.5f}, every grad leaf finite, launches "
        f"{counts}; {QWEN_TRAIN_STEPS} AdamW steps: losses {losses}, step ms "
        + ", ".join(f"{t:.3f}" for t in times)
        + f" (mean after the first {step_ms:.3f}, "
        f"{PREFILL_B * PREFILL_S / (step_ms / 1e3):.0f} tokens/s), peak "
        f"{peak / 2**30:.3f} GiB ({card})")
    if any(c != want for c in step_counts) or not all(np.isfinite(losses)) \
            or not np.isfinite(float(last["grad_norm"])):
        raise AssertionError(f"{QWEN} train steps: launches {step_counts}, "
                             f"losses {losses}")
    del params, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "times": times, "peak_bytes": peak,
            "params": n, "launches": counts}


def phase_train_driver():
    """A main path: ``repro_torch.launch.train.main`` on smollm-360m at full
    width cut to DRIVER_LAYERS in bf16, B=8, S=1024, through the runtime: ``train_segment``
    SPMD tasks of 2 steps beside ``evaluate`` and ``commit_checkpoint``
    Python tasks in one pilot on the card.  Three runs: 4 steps with
    checkpoints and one evaluation; the same with ``--inject-failure 1``
    (a slot of the running segment fails: the segment is retried and
    resumes from its last saved step, so its retry runs no step); a
    restart from the first run's checkpoint to step 6.

    Counts set to 0 just before each run and read just after: remat
    "full" launches K1 twice per layer and step (forward and recompute)
    and once per layer for an evaluation (forward only, without lse),
    K1b once per layer and step.  Counts read inside each segment's body
    show the kernels ran in the pilot task: K1b exactly once per layer and
    step there.  The device's peak after each segment must not grow by
    256 MB from segment to segment (a training state at 8 layers is 1.3
    GB, at full depth 3.6).  The runtime's
    overhead comes from the pilot's event stream."""
    from repro_torch.configs import get_config
    from repro_torch.core import overhead_from_events
    from repro_torch.launch import train
    cfg = dataclasses.replace(get_config("smollm-360m"),
                              num_layers=DRIVER_LAYERS)
    L = cfg.num_layers
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    drill = ROOT / "build" / "chip_smoke_ckpt_drill"
    runs = []
    try:
        for name, steps, evals, segments, extra in (
                ("run", 4, 1, 2, ["--ckpt-dir", str(ckpt)]),
                ("drill", 4, 1, 2, ["--ckpt-dir", str(drill),
                                    "--ckpt-every", "4",
                                    "--inject-failure", "1"]),
                ("restart", 6, 0, 1, ["--ckpt-dir", str(ckpt)])):
            if name != "restart":
                shutil.rmtree(ROOT / extra[1], ignore_errors=True)
            argv = TRAIN_ARGV + ["--layers", str(L), "--steps",
                                 str(steps)] + extra
            # a finished run's pilot, agents and task records form
            # reference cycles that hold its tensors until the cycle
            # collector runs: collect them, so each run's peak is its own
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reset_launches()                    # the main path starts here
            rec = {}
            losses = train.main(argv, rec)
            torch.cuda.synchronize()
            counts = read_launches()            # ... and ends here
            seconds = time.perf_counter() - t0
            n = 2 * segments
            want = {"flash_attention_fwd": 2 * L * n + L * evals,
                    "flash_attention_bwd": L * n, "ssd_chunk_kernel": 0,
                    "ssd_chunk_bwd_kernel": 0, "ssd_pass_kernel": 0,
                    "ssd_pass_bwd_kernel": 0}
            peaks = [s["peak_bytes"] for s in rec["segments"]]
            log(f"[train] driver ({name}) to step {steps}: losses {losses}, "
                f"launches {counts} (expected {want}), {seconds:.1f}s with "
                "checkpoints; peak after each segment "
                + ", ".join(f"{p / 2**30:.3f}" for p in peaks) + " GiB")
            if len(losses) != segments or len(rec["segments"]) != segments:
                raise AssertionError(f"train ({name}) to step {steps} ran "
                                     f"{len(losses)} segments, expected "
                                     f"{segments}")
            if counts != want:
                raise AssertionError(f"train ({name}) launched {counts}, "
                                     f"expected {want}")
            if max(peaks) > peaks[0] + 2**28:
                raise AssertionError(f"train ({name}): device peak grew from "
                                     f"segment to segment: {peaks}")
            tasks = segment_tasks(rec)
            for t in tasks:
                log(f"[train] ({name}) train_segment {t['uid']}: attempts "
                    f"ran {t['steps']} steps, body {t['body_s']:.4f}s, task "
                    f"{t['task_s']:.4f}s (first event to DONE), outside its "
                    f"body {t['outside_s']:.4f}s; launches inside the body "
                    f"{t['launches']}")
                inside = t["launches"]
                if (inside["flash_attention_bwd"] != L * sum(t["steps"])
                        or inside["flash_attention_fwd"]
                        < 2 * L * sum(t["steps"])):
                    raise AssertionError(f"train ({name}): {t['uid']} "
                                         f"launched {inside} inside its body")
            overhead = overhead_from_events(rec["events"])
            log(f"[train] ({name}) runtime overhead (union of SCHEDULED -> "
                f"RUNNING over all tasks, overhead_from_events): "
                f"{overhead:.6f}s over {len(rec['events'])} events")
            if name == "drill":
                hit = [t for t in tasks if t["uid"] in rec["victims"]]
                if len(rec["victims"]) != 1 or len(hit) != 1 or \
                        hit[0]["steps"] != [2, 0]:
                    raise AssertionError(
                        f"train (drill): victims {rec['victims']}, attempts "
                        f"{[t['steps'] for t in hit]}; expected one segment "
                        "failed and retried without rerunning its steps")
            runs.append({"name": name, "losses": losses, "counts": counts,
                         "peaks": peaks, "seconds": seconds, "tasks": tasks,
                         "overhead_s": overhead})
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        shutil.rmtree(drill, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    run, drill_run, restart = runs
    losses = run["losses"] + restart["losses"]
    if not all(np.isfinite(losses + drill_run["losses"])) or \
            not losses[-1] < losses[0] + 0.2:
        raise AssertionError(f"train losses {losses}: not finite or not "
                             "moving the right way")
    return {"launches": run["counts"]["flash_attention_bwd"],
            # the restart ran 2 steps and no evaluation
            "per_step": {k: v // 2 for k, v in restart["counts"].items()},
            "peak_bytes": max(max(r["peaks"]) for r in runs),
            "losses": losses, "runs": runs}


def segment_tasks(rec):
    """Each train_segment task of a driver run: its attempts' steps and
    body seconds, kernel launches read inside its bodies, and its task
    time from its first event to DONE in the pilot's event stream."""
    out = []
    for seg in rec["segments"]:
        evs = [e for e in rec["events"]
               if e.get("event") == "STATE" and e.get("uid") == seg["uid"]]
        t_done = max(e["t"] for e in evs if e["state"] == "DONE")
        task_s = t_done - min(e["t"] for e in evs)
        body_s = sum(a["seconds"] for a in seg["attempts"])
        launches = {}
        for a in seg["attempts"]:
            for k, v in a["launches"].items():
                launches[k] = launches.get(k, 0) + v
        out.append({"uid": seg["uid"], "steps": [a["steps_run"]
                                                 for a in seg["attempts"]],
                    "body_s": body_s, "task_s": task_s,
                    "outside_s": task_s - body_s, "launches": launches})
    return out


def phase_prefill(cfg, params, routes, seed, B=PREFILL_B, S=PREFILL_S,
                  patches=0, iters=10):
    """A main path: ``make_prefill_step`` at full width (bf16, B=8, S=1024
    unless ``B`` and ``S`` say otherwise; ``patches`` > 0 puts that many
    patch positions in front of the S text tokens, drawn as the data
    pipeline draws them, for a ``vision_stub`` arch).

    ``routes``: (ops name, plain version, check, tol) of each kernel the
    path runs; ``check`` returns a tuple of readings, the largest
    |kernel - plain| first, and ``tol`` says what it holds them to.  Every launch count is set to 0 just before the step and
    read just after it: K1 once per attention layer, K2 once per mamba
    layer and nothing else (``expected_launches``).  Then, on the same
    batch, each kernel's output in every layer against its plain version on
    that layer's own inputs (``check`` raises beyond ``tol``), the
    last-token logits with every ``ops.<name>`` replaced by its plain
    version (PREFILL_TOL), and the step's time.

    With experts, the main path records each MoE layer's expert choices
    and the plain route replays them (``moe_routes``): a bf16 difference in
    attention moves the router logits, and with top-k of many experts a
    near-tie then flips a choice.  The plain route is also run without the
    replay, and the share of (token, k) choices that differ is reported.
    """
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    n = param_count(params)
    if n != cfg.param_count():
        raise AssertionError(f"{cfg.name}: {n} params, config says "
                             f"{cfg.param_count()}")
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S))).cuda()}
    if patches:
        batch["patches"] = patch_batch(cfg, B, patches, rng)
    prefill = M.make_prefill_step(cfg)
    idxs = []

    torch.cuda.reset_peak_memory_stats()
    with moe_routes(record=idxs):
        reset_launches()                        # the main path starts here
        logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        counts = read_launches()                # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    want = expected_launches(cfg)
    if counts != want:
        raise AssertionError(f"{cfg.name} prefill launched {counts}, expected "
                             f"{want}")
    if logits.shape != (B, 1, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"{cfg.name} prefill logits {tuple(logits.shape)} "
                             "not finite or of the wrong shape")
    # an attention layer's k and v (B, S_total, Hkv, D) hold every position
    if len(cache) != cfg.num_layers or any(
            kind in ("attn", "local_attn") and c[0].shape[1] != S + patches
            for (kind, _), c in zip(T.layer_program(cfg), cache)) \
            or not all(bool(torch.isfinite(t).all())
                       for c in cache for t in c):
        raise AssertionError(f"{cfg.name} prefill cache not finite or not "
                             f"{S + patches} long")
    del cache
    log(f"[prefill] {cfg.name} ({n} params, {cfg.num_layers} layers) bf16 "
        f"B={B} S={S}" + (f" after {patches} patch positions" if patches
                          else "")
        + f": launches {counts}, peak {peak / 2**30:.2f} GiB")
    if cfg.num_experts:
        drops = dropped(cfg, idxs)
        log(f"[prefill] {cfg.name}: {drops[0]} of {drops[1]} expert "
            f"assignments dropped past capacity (capacity_factor "
            f"{cfg.capacity_factor})")

    # every layer's kernel output against the plain version on the layer's
    # own inputs: the main path's activations
    layer_err = {}
    for name, plain, check, tol in routes:
        errs = []
        kernel_route = getattr(ops, name)

        def checked(*args, kernel_route=kernel_route, plain=plain,
                    check=check, errs=errs, **kw):
            out = kernel_route(*args, **kw)
            errs.append(check(out, plain(*args, **kw), f"layer {len(errs)}"))
            return out

        with moe_routes(replay=idxs if cfg.num_experts else None):
            prefill_with({name: checked}, prefill, params, batch)
        worst = [max(r) for r in zip(*errs)]    # each reading's worst layer
        layer_err[name] = worst[0]
        log(f"[prefill] {cfg.name} per layer, {name} kernel vs plain on the "
            f"layer's own inputs: {len(errs)} layers, max |diff| "
            f"{worst[0]:.4g}" + (f", normwise {worst[1]:.4g}"
                                 if len(worst) > 1 else "")
            + f" (tol {tol})")

    # the whole step through the plain versions
    plain_routes = {name: plain for name, plain, _, _ in routes}
    with moe_routes(replay=idxs if cfg.num_experts else None):
        plain_logits, _ = prefill_with(plain_routes, prefill, params, batch)
    torch.cuda.synchronize()
    err = float((logits.float() - plain_logits.float()).abs().max())
    agree = float((logits.argmax(-1) == plain_logits.argmax(-1)).float().mean())
    log(f"[prefill] {cfg.name} last-token logits, kernel vs plain"
        + (", expert choices replayed" if cfg.num_experts else "")
        + f": max |diff| {err:.4g} (tol {PREFILL_TOL}, max |logit| "
        f"{float(plain_logits.float().abs().max()):.4g}), "
        f"argmax agreement {agree:.3f}")
    if not err <= PREFILL_TOL:
        raise AssertionError(f"{cfg.name} prefill kernel vs plain: {err} > "
                             f"{PREFILL_TOL}")
    if cfg.num_experts:
        free_idxs = []
        with moe_routes(record=free_idxs):
            free_logits, _ = prefill_with(plain_routes, prefill, params, batch)
        flips = (sum(int((a != b).sum()) for a, b in zip(idxs, free_idxs))
                 / sum(a.numel() for a in idxs))
        free_err = float((logits.float() - free_logits.float()).abs().max())
        log(f"[prefill] {cfg.name} plain route without the replay (a report): "
            f"{flips:.5f} of the (token, k) expert choices differ from the "
            f"kernel route's; last-token logits max |diff| {free_err:.4g}, "
            "argmax agreement "
            f"{float((logits.argmax(-1) == free_logits.argmax(-1)).float().mean()):.3f}")
    step_ms = cuda_ms(lambda: prefill(params, batch), iters=iters, warmup=2)
    log(f"[prefill] {cfg.name} step {step_ms:.3f} ms (B={B}, S={S}"
        + (f" after {patches} patch positions" if patches else "") + ")")
    return {"launches": counts, "step_ms": step_ms, "peak_bytes": peak,
            "layer_err": layer_err, "batch": batch, "logits": logits}


def patch_batch(cfg, B, n, rng):
    """(B, n, d_model) patch embeddings on the card, drawn as the data
    pipeline draws them (standard normal times 0.02), in f32: the model
    casts them to its dtype."""
    return torch.from_numpy((rng.standard_normal((B, n, cfg.d_model))
                             * 0.02).astype(np.float32)).cuda()


def prefill_and_decode(cfg, params, B, S, seed):
    """f32 prefill through the kernels (launches as ``expected_launches``)
    and S token-by-token decode steps from a zero cache: (prefill logits,
    last decode logits)."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    toks = torch.from_numpy(
        np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))).cuda()
    reset_launches()
    logits_p, _ = M.make_prefill_step(cfg)(params, {"tokens": toks})
    torch.cuda.synchronize()
    counts = read_launches()
    if counts != expected_launches(cfg):
        raise AssertionError(f"{cfg.name} f32 prefill launched {counts}")
    decode = M.make_decode_step(cfg)
    cache = T.init_cache(cfg, B, S, "float32", device="cuda")
    for t in range(S):
        lg, cache = decode(params, toks[:, t:t + 1], cache, t)
    torch.cuda.synchronize()
    return logits_p, lg


def phase_prefill_vs_decode(cfg, params, B, S, seed):
    """f32 prefill through the kernels against S token-by-token decode steps:
    0.1 and equal argmax, the contract of tests/test_models_smoke.py."""
    logits_p, lg = prefill_and_decode(cfg, params, B, S, seed)
    err, ok = max_excess(lg, logits_p, 0.1)
    same = bool((lg.argmax(-1) == logits_p.argmax(-1)).all())
    log(f"[decode] {cfg.name} f32 B={B} S={S}: prefill (kernel) vs "
        f"token-by-token decode max |diff| {err:.3g}, argmax equal {same}")
    if not (ok and same and torch.isfinite(lg).all()):
        raise AssertionError(f"{cfg.name} prefill and decode disagree")


def phase_moe_prefill(cfg, params, seed):
    """A main path for an MoE arch (``phase_prefill``, routes replayed),
    then the ``gather`` dispatch against ``einsum`` on the same params and
    batch (PREFILL_TOL; both run the same expert choices, since the router
    sees the same attention output), and the step under each dispatch,
    timed in turns (einsum, gather, gather, einsum) with each one's peak."""
    from repro_torch.models import model as M
    res = phase_prefill(cfg, params, [FLASH_ROUTE], seed)
    batch = res.pop("batch")
    steps = {d: M.make_prefill_step(dataclasses.replace(cfg, moe_dispatch=d))
             for d in ("einsum", "gather")}
    reset_launches()
    g_logits, _ = steps["gather"](params, batch)
    torch.cuda.synchronize()
    counts = read_launches()
    if counts != expected_launches(cfg):
        raise AssertionError(f"{cfg.name} gather prefill launched {counts}")
    err = float((g_logits.float() - res.pop("logits").float()).abs().max())
    log(f"[prefill] {cfg.name} gather dispatch vs einsum, last-token logits: "
        f"max |diff| {err:.4g} (tol {PREFILL_TOL})")
    if not (err <= PREFILL_TOL and torch.isfinite(g_logits).all()):
        raise AssertionError(f"{cfg.name} gather and einsum dispatches "
                             f"disagree: {err}")
    peaks = {}
    for d, step in steps.items():
        torch.cuda.reset_peak_memory_stats()
        step(params, batch)
        torch.cuda.synchronize()
        peaks[d] = torch.cuda.max_memory_allocated()
    run = {d: (lambda step=step: step(params, batch)) for d, step in steps.items()}
    t_e, t_g = in_turns(run["einsum"], run["gather"], iters=10)
    log(f"[prefill] {cfg.name} bf16 B={PREFILL_B} S={PREFILL_S} step: einsum "
        f"{t_e[0]:.3f} / {t_e[1]:.3f} ms (peak {peaks['einsum'] / 2**30:.2f} "
        f"GiB), gather {t_g[0]:.3f} / {t_g[1]:.3f} ms (peak "
        f"{peaks['gather'] / 2**30:.2f} GiB), in turns: einsum, gather, "
        "gather, einsum")
    return res


def phase_moe_prefill_vs_decode(cfg, seed):
    """f32 prefill against token-by-token decode for an MoE arch, B=2,
    S=32.  The gate (0.1 and equal argmax, as for the dense archs) runs at
    capacity_factor E/K, so C is the group's token count and the prefill
    drops nothing; decode at B=2 never drops (C >= 4 > B).  So it tests the
    KV-cache path alone.  Then, at the config's capacity factor, the
    prefill's dropped assignments and the reference's looser MoE contract
    (0.25 and equal argmax, tests/test_models_smoke.py), evaluated and
    printed."""
    params = smoke_params(cfg, seed)
    B, S = 2, 32
    n_moe = sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.num_layers))
    free = dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    idxs = []                   # the prefill's MoE layers come first
    with moe_routes(record=idxs):
        phase_prefill_vs_decode(free, params, B, S, seed)
    n_free = dropped(free, idxs[:n_moe])[0]
    idxs = []
    with moe_routes(record=idxs):
        logits_p, lg = prefill_and_decode(cfg, params, B, S, seed)
    n, total = dropped(cfg, idxs[:n_moe])
    err, ok = max_excess(lg, logits_p, 0.25)
    same = bool((lg.argmax(-1) == logits_p.argmax(-1)).all())
    log(f"[decode] {cfg.name} f32 B={B} S={S}: the gate ran at "
        f"capacity_factor {free.capacity_factor} ({n_free} dropped); at the "
        f"config's {cfg.capacity_factor} the prefill drops {n} of {total} "
        f"assignments, and decode gives the prefill's logits within "
        f"{err:.3g}, argmax equal {same}: the reference's MoE contract (0.25 "
        f"and equal argmax) {'holds' if ok and same else 'fails'} (reported, "
        "not a gate)")
    if n_free:
        raise AssertionError(f"{cfg.name}: the drop-free prefill dropped "
                             f"{n_free} assignments")


def phase_serve(arch, cfg=None, params=None, reduced=False):
    """The serve loop, 8 requests on 4 slots, up to 16 new tokens each:
    ``serve.main`` (params made inside, their init timed too), or
    ``serve.run`` on ``cfg`` and ``params`` where given (a depth-cut config:
    ``serve.main`` would make the whole model)."""
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--requests", "8", "--batch-slots", "4",
            "--max-new", "16"] + (["--reduced"] if reduced else [])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outputs = (serve.main(argv) if cfg is None
               else serve.run(cfg, params, serve.parse_args(argv)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if len(outputs) != 8 or not all(len(v) >= 1 for v in outputs.values()):
        raise AssertionError(f"serve {arch} answered {outputs}")
    generated = sum(len(v) for v in outputs.values())
    log(f"[serve] {arch}" + (f" ({cfg.num_layers} layers)" if cfg else "")
        + (" reduced" if reduced else "")
        + f": 8/8 requests answered, {generated} tokens generated in "
        f"{seconds:.3f}s" + (" (param init included)" if cfg is None else "")
        + f": {generated / seconds:.1f} generated tok/s")
    return generated / seconds


def phase_timings(card, shape=(PREFILL_B, PREFILL_S, 15, 5, 64)):
    """K1 (bf16, causal) at a prefill's attention shape: smollm-360m's by
    default; qwen3-moe's and dbrx's for the MoE paths."""
    import torch.nn.functional as F
    from repro_torch.kernels.cost import flash_fwd_cost
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)
    q, k, v = qkv(shape, torch.bfloat16, seed=1)
    ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, causal=True), iters=20)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True),
                       iters=5, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), iters=20)
    flops, nbytes = flash_fwd_cost(q, k, causal=True)  # q.k and p.v
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"[timing] {card}: flash_attention_fwd {shape} bf16 causal: "
        f"{ms:.4f} ms; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB; bound "
        f"{bound_ms:.4f} ms ({bound_by}), "
        f"{100 * bound_ms / ms:.2f}% of bound; plain {plain_ms:.4f} ms; "
        f"scaled_dot_product_attention {library_ms:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_train_timings(card):
    """K1 with and without its lse, K1b against its plain version and SDPA's
    backward at the training shape, and against SDPA's backward at the
    D=128 shape; then the full-width train step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamW, cosine_schedule
    shape = TRAIN_SHAPE
    q, k, v = qkv(shape, torch.bfloat16, seed=7)
    fwd = lambda: flash_attention_fwd(q, k, v, causal=True)
    fwd_lse = lambda: flash_attention_fwd(q, k, v, causal=True, with_lse=True)
    t_no, t_lse = in_turns(fwd, fwd_lse, iters=20)
    log(f"[timing] {card}: flash_attention_fwd {shape} bf16 causal without "
        f"lse {t_no[0]:.4f} / {t_no[1]:.4f} ms, with lse {t_lse[0]:.4f} / "
        f"{t_lse[1]:.4f} ms (in turns: without, with, with, without)")
    bwd = bwd_timing(card, TRAIN_SHAPE, seed=7)
    d128 = bwd_timing(card, D128_SHAPE, seed=14)

    cfg = get_config("smollm-360m")
    params = T.init_params(cfg, 0, device="cuda")
    opt = AdamW(lr=cosine_schedule(3e-4, 20, 10_000))
    state = opt.init(params)
    step = M.make_train_step(cfg, opt)
    rng = np.random.default_rng(13)
    toks = rng.integers(0, cfg.vocab_size, (PREFILL_B, PREFILL_S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).cuda(),
             "targets": torch.from_numpy(toks[:, 1:]).cuda(),
             "loss_mask": torch.ones((PREFILL_B, PREFILL_S), device="cuda")}
    holder = [params, state]

    def run():
        holder[0], holder[1], _ = step(holder[0], holder[1], batch)
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(run, iters=5, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    tok_s = PREFILL_B * PREFILL_S / (step_ms / 1e3)
    log(f"[timing] {card}: smollm-360m train step bf16 B={PREFILL_B} "
        f"S={PREFILL_S} remat {cfg.remat}: {step_ms:.3f} ms, {tok_s:.0f} "
        f"tokens/s, peak {peak / 2**30:.3f} GiB")
    # the same step beside an idle pilot (its agent and pool threads
    # alive, no task running), then alone again: what the runtime's
    # threads cost a host-bound step
    from repro_torch.core import PilotDescription, RPEXExecutor
    rpex = RPEXExecutor(PilotDescription(n_slots=4,
                                         devices=[torch.device("cuda", 0)]))
    try:
        idle_ms = cuda_ms(run, iters=5, warmup=1)
    finally:
        rpex.shutdown()
    alone_ms = cuda_ms(run, iters=5, warmup=1)
    log(f"[timing] {card}: the same train step beside an idle pilot "
        f"{idle_ms:.3f} ms, then alone again {alone_ms:.3f} ms")
    return {**bwd, "d128": d128, "fwd_no_lse_ms": t_no, "fwd_lse_ms": t_lse,
            "step_ms": step_ms, "tok_s": tok_s, "peak_bytes": peak,
            "idle_pilot_ms": idle_ms, "alone_ms": alone_ms}


def bwd_timing(card, shape, seed):
    """K1b (bf16, causal) at ``shape`` against the backward of SDPA on the
    same inputs, in turns (kernel, library, library, kernel), and its plain
    version; the bound counts the five products a backward needs, and q k
    v o do lse in, dq dk dv out."""
    import torch.nn.functional as F
    from repro_torch.kernels.cost import flash_bwd_cost
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_fwd)
    q, k, v = qkv(shape, torch.bfloat16, seed=seed)
    do = qkv(shape, torch.bfloat16, seed=seed + 1)[0]
    o, lse = flash_attention_fwd(q, k, v, causal=True, with_lse=True)
    kernel = lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    # the library's backward: SDPA (B, H, S, D) forward once, its graph
    # kept, and only torch.autograd.grad timed
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    dot = do.transpose(1, 2)
    library = lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                          retain_graph=True)
    t_k, t_l = in_turns(kernel, library, iters=20)
    ms, library_ms = sum(t_k) / 2, sum(t_l) / 2
    plain_ms = cuda_ms(lambda: flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal=True), iters=3, warmup=1)
    flops, nbytes = flash_bwd_cost(q, k, causal=True)   # five products
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"[timing] {card}: flash_attention_bwd {shape} bf16 causal: "
        f"{t_k[0]:.4f} / {t_k[1]:.4f} ms; {flops / 1e9:.3f} GFLOP (5 "
        f"products; the kernel runs 7), {nbytes / 1e6:.2f} MB; bound "
        f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.2f}% of "
        f"bound; plain {plain_ms:.4f} ms; scaled_dot_product_attention "
        f"backward {t_l[0]:.4f} / "
        f"{t_l[1]:.4f} ms (torch.autograd.grad through "
        f"{out.grad_fn.name()}, is_causal, enable_gqa, on a kept graph; in "
        "turns: kernel, library, library, kernel)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


SSD_TERMS = ("y_intra", "states", "decay_all", "decay_chunk")


def ssd_inputs(shape, dtype, seed):
    """x, dt, A, B_, C_ for the SSD chunk terms; x, B_ and C_ are split
    views of one (B, S, H*P + 2N) tensor, as ``mamba_layer`` hands them to
    the kernel.  At the sweep's shapes (N < 64) they are drawn as the
    reference's sweep draws them.  At N >= 64 (the mamba2 shape, the route
    shapes of SSD_ROUTE_SHAPES from N = 128 on) they are drawn at the model's
    scale (tools/ssd_conditioning.py, draw "model"): with unit-normal x, B,
    C and N = 128 a 256-long chunk sums terms of up to ~500, and f32
    rounding on either route alone then misses a float64 truth by more
    than 5e-4 (that tool measures it)."""
    from tools.ssd_conditioning import draw
    B, S, H, P, N, _ = shape
    return draw(B, S, H, P, N, dtype, "model" if N >= 64 else "sweep", seed)


def check_ssd_terms(got, want, what):
    """Each term finite and within SSD_TOL of the plain version; returns
    (the largest |kernel - plain|,)."""
    worst = 0.0
    for name, g, w in zip(SSD_TERMS, got, want):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"ssd_chunk_kernel {what}: {name} "
                                 f"{tuple(g.shape)} not finite or misshapen")
        err, ok = max_excess(g, w, SSD_TOL)
        if not ok:
            raise AssertionError(f"ssd_chunk_kernel {what}: {name} max "
                                 f"|kernel-plain| {err} over tol {SSD_TOL}")
        worst = max(worst, err)
    return (worst,)


def phase_ssd_vs_plain():
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_sequential
    from repro_torch.kernels.ssd import ssd_chunk_kernel, ssd_chunk_plain
    from repro_torch.kernels.ssd import ssd_route
    worst = {}
    cases = ([(shape, dtype, None) for shape in SSD_SWEEP + [MAMBA_SHAPE]
              for dtype in (torch.float32, torch.bfloat16)]
             + [(shape, torch.bfloat16, route)
                for shape, route in SSD_ROUTE_SHAPES])
    for shape, dtype, route in cases:
        args = ssd_inputs(shape, dtype, seed=0)
        if route is not None and ssd_route(args[0], args[3], args[4],
                                           shape[-1]) != route:
            raise AssertionError(f"ssd_route {shape}: not {route}")
        got = ssd_chunk_kernel(*args, chunk=shape[-1])
        torch.cuda.synchronize()
        want = ssd_chunk_plain(*args, chunk=shape[-1])
        err, = check_ssd_terms(got, want, f"{shape} {dtype}")
        key = ("mamba2 shape" if shape == MAMBA_SHAPE else "sweep"
               if route is None else f"{shape} {route}")
        worst[key, dtype] = max(worst.get((key, dtype), 0.0), err)
    log(f"[kernel] ssd_chunk_kernel, {len(SSD_SWEEP)} sweep shapes and the "
        f"mamba2 shape {MAMBA_SHAPE} x f32/bf16, and the bf16 route shapes "
        "(P = 128 and the edge between the wgmma and mma.sync routes), 4 "
        "terms each, all finite: "
        + ", ".join(f"{k} {dt} max |kernel-plain| {e:.3g}"
                    for (k, dt), e in worst.items()) + f" (tol {SSD_TOL})")
    # the whole scan through the kernel, from a nonzero state
    shape = (2, 64, 4, 16, 8, 16)
    x, dt, A, B_, C_ = ssd_inputs(shape, torch.float32, seed=1)
    h0 = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 4, 16, 8), np.float32)).cuda()
    before = ssd_chunk_kernel.launches
    y, h = ops.ssd(x, dt, A, B_, C_, shape[-1], h0=h0)
    torch.cuda.synchronize()
    if ssd_chunk_kernel.launches != before + 1:
        raise AssertionError("ops.ssd did not launch ssd_chunk_kernel")
    sy, sh = ssd_sequential(x, dt, A, B_, C_, h0=h0)
    err_y, ok_y = max_excess(y, sy, SSD_TOL)
    err_h, ok_h = max_excess(h, sh, SSD_TOL)
    log(f"[kernel] ops.ssd {shape} f32 from a nonzero h0 vs ssd_sequential: "
        f"y {err_y:.3g}, final state {err_h:.3g} (tol {SSD_TOL})")
    if not (ok_y and ok_h):
        raise AssertionError("ops.ssd through the kernel disagrees with "
                             "ssd_sequential")
    return max(worst.values())


# the recurrence between chunks, K3 and K3b, against their plain versions
# on the same inputs (K2's terms of ``ssd_inputs``): mamba2-1.3b's train
# workflow shape (B=4, S=4096), its score campaign's (B=32, S=1024) and
# jamba's head dim P=128 (128 heads, S=4096), in bf16 (mma.sync) and f32
# (CUDA cores), and the sweep's shapes (CUDA cores in both types).  Gates:
# each output and gradient within SSD_TOL elementwise and SSD_BWD_NORM_TOL
# normwise, the SSD backward's gates: kernel and plain version form the same
# f32 products (the kernel's three-part splits are as good as f32) and the
# same f32 walk over the chunks; bf16 y, rounded once from its f32 sum, is
# held through that rounding (check_rounded) against the plain f32 sum
PASS_TRAIN = (4, 4096, 64, 64, 128, 256)
PASS_SCORE = (32, 1024, 64, 64, 128, 256)
PASS_JAMBA = (1, 4096, 128, 128, 128, 256)
PASS_OUTS = ("y", "hT", "h_prev")
PASS_GRADS = ("d y_intra", "d states", "d decay_all", "d decay_chunk", "dC",
              "dh0")


def ssd_pass_grads_plain(dy, dhT, h_prev, decay_all, decay_chunk, C_, *,
                         with_dh0):
    """``ops.ssd_pass_grads``'s plain route: K3b's plain version, dh0 kept
    only where the caller asks for it."""
    from repro_torch.kernels.ref import ssd_pass_bwd_plain
    *grads, dh0 = ssd_pass_bwd_plain(dy, dhT, h_prev, decay_all,
                                     decay_chunk, C_)
    return (*grads, dh0 if with_dh0 else None)


def ssd_plain_routes():
    """Each SSD kernel's ``ops`` entry and its plain version (K2, K2b, K3,
    K3b), for ``route_compare``."""
    from repro_torch.kernels.ref import ssd_pass_plain
    from repro_torch.kernels.ssd import ssd_chunk_bwd_plain, ssd_chunk_plain
    return {"ssd_chunk": ssd_chunk_plain, "ssd_chunk_grads": ssd_chunk_bwd_plain,
            "ssd_pass": ssd_pass_plain, "ssd_pass_grads": ssd_pass_grads_plain}


def check_pass_terms(got, want, what):
    """K3's (y, hT, h_prev) against the plain version's on the same inputs
    (a prefill layer's): y in its own type within TOL and FWD_NORM_TOL (two
    roundings of nearly equal f32 sums), the states within SSD_TOL and
    SSD_BWD_NORM_TOL; returns (largest |kernel - plain|, largest
    normwise error)."""
    worst = (0.0, 0.0)
    for name, g, w in zip(PASS_OUTS, got, want):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"ssd_pass_kernel {what}: {name} "
                                 f"{tuple(g.shape)} not finite or misshapen")
        tol, norm_tol = ((TOL[g.dtype], FWD_NORM_TOL[g.dtype]) if name == "y"
                         else (SSD_TOL, SSD_BWD_NORM_TOL))
        err, ok = max_excess(g, w, tol)
        rel = norm_error(g, w)
        if not (ok and rel <= norm_tol):
            raise AssertionError(f"ssd_pass_kernel {what}: {name} max "
                                 f"|kernel-plain| {err} (tol {tol}), "
                                 f"normwise {rel} (tol {norm_tol})")
        worst = (max(worst[0], err), max(worst[1], rel))
    return worst


def pass_gate(name, got, want, what, rounded_from=None):
    """One output or gradient of K3/K3b against the plain version: finite,
    of the plain version's shape, within SSD_TOL and SSD_BWD_NORM_TOL (bf16
    through its one rounding against ``rounded_from``); (max, normwise)."""
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: {name} {tuple(got.shape)} not finite "
                             "or misshapen")
    if rounded_from is not None:
        err, ok, rel = check_rounded(got, rounded_from, SSD_TOL,
                                     SSD_BWD_NORM_TOL)
    else:
        err, ok = max_excess(got, want, SSD_TOL)
        rel = norm_error(got, want)
        ok = ok and rel <= SSD_BWD_NORM_TOL
    if not ok:
        raise AssertionError(f"{what}: {name} max |kernel-plain| {err} (tol "
                             f"{SSD_TOL}), normwise {rel} (tol "
                             f"{SSD_BWD_NORM_TOL})")
    return err, rel


def dispatched_ops(fn):
    """The number of aten ops ``fn`` dispatches, its backward's included."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))
    with Count():
        fn()
    return Count.n


def phase_ssd_pass_vs_plain():
    """K3 and K3b against ``ssd_pass_plain`` and ``ssd_pass_bwd_plain`` on
    the same inputs (PASS_* and the sweep; h0 and dhT given except at the
    train shape, the main path's), each call twice and bitwise equal, the
    route each takes; then ``ops.ssd`` forward and backward at 4 and at 16
    chunks: K3 and K3b once each, and the same number of aten ops at both
    (no loop over chunks on the CUDA route)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_pass_bwd_plain, ssd_pass_plain
    from repro_torch.kernels.ssd import ssd_chunk_kernel
    from repro_torch.kernels.ssd_pass import (pass_route, ssd_pass_bwd_kernel,
                                              ssd_pass_kernel)
    worst = {}
    cases = ([(shape, dtype) for shape in (PASS_TRAIN, PASS_SCORE, PASS_JAMBA)
              for dtype in (torch.bfloat16, torch.float32)]
             + [(shape, dtype) for shape in SSD_SWEEP
                for dtype in (torch.bfloat16, torch.float32)])
    for shape, dtype in cases:
        B, S, H, P, N, Q = shape
        x, dt, A, B_, C_ = ssd_inputs(shape, dtype, seed=60)
        terms = ssd_chunk_kernel(x, dt, A, B_, C_, chunk=Q)
        del x, dt, A, B_
        route = pass_route(C_, P)
        if route != ("mma" if dtype == torch.bfloat16 and P in (64, 128)
                     and N <= 128 else "f32"):
            raise AssertionError(f"pass_route {shape} {dtype}: {route}")
        rng = torch.Generator(device="cuda").manual_seed(61)
        state = shape != PASS_TRAIN
        h0 = (torch.randn((B, H, P, N), device="cuda", generator=rng)
              * terms[1].std() if state else None)
        dy = torch.randn((B, S, H, P), device="cuda", generator=rng).to(dtype)
        dhT = (torch.randn((B, H, P, N), device="cuda", generator=rng)
               if state else None)
        what = f"ssd_pass {shape} {dtype} ({route})"
        got = ssd_pass_kernel(*terms, C_, h0, dtype=dtype)
        again = ssd_pass_kernel(*terms, C_, h0, dtype=dtype)
        want = ssd_pass_plain(*terms, C_, h0, dtype=torch.float32)
        errs = []
        for name, g, g2, w in zip(PASS_OUTS, got, again, want):
            if not torch.equal(g, g2):
                raise AssertionError(f"{what}: {name} differs between runs")
            bf = name == "y" and dtype == torch.bfloat16
            errs.append(pass_gate(name, g, w, what, w if bf else None))
        h_prev = want[2]
        del got, again, want
        got = ssd_pass_bwd_kernel(dy, dhT, h_prev, terms[2], terms[3], C_,
                                  with_dh0=state)
        again = ssd_pass_bwd_kernel(dy, dhT, h_prev, terms[2], terms[3], C_,
                                    with_dh0=state)
        want = ssd_pass_bwd_plain(dy, dhT, h_prev, terms[2], terms[3], C_)
        torch.cuda.synchronize()
        for name, g, g2, w in zip(PASS_GRADS, got, again, want):
            if g is None:
                continue
            if not torch.equal(g, g2):
                raise AssertionError(f"{what}: {name} differs between runs")
            errs.append(pass_gate(name, g, w, what))
        key = ("sweep" if shape in SSD_SWEEP else str(shape), dtype)
        e0, r0 = worst.get(key, (0.0, 0.0))
        worst[key] = (max([e0] + [e for e, _ in errs]),
                      max([r0] + [r for _, r in errs]))
        del got, again, want, terms, h_prev, dy, dhT, h0, C_
        gc.collect()
        torch.cuda.empty_cache()
    log("[kernel] ssd_pass_kernel and ssd_pass_bwd_kernel (K3, K3b), the "
        f"train shape {PASS_TRAIN}, the score shape {PASS_SCORE}, jamba's "
        f"P=128 {PASS_JAMBA} and {len(SSD_SWEEP)} sweep shapes x bf16/f32, "
        "y hT h_prev and every gradient, each call twice and bitwise equal: "
        + ", ".join(f"{k} {dt} max |kernel-plain| {e:.3g}, normwise {r:.3g}"
                    for (k, dt), (e, r) in worst.items())
        + f" (tol {SSD_TOL} abs + rel, normwise {SSD_BWD_NORM_TOL}; bf16 y "
        "through its one rounding)")
    # the main path runs no loop over chunks: the same ops at 4 and 16
    counts = {}
    for S in (1024, 4096):
        args = [t.detach().requires_grad_() for t in ssd_inputs(
            (1, S, 4, 64, 128, 256), torch.bfloat16, seed=62)]
        k0, b0 = ssd_pass_kernel.launches, ssd_pass_bwd_kernel.launches

        def step():
            y, _ = ops.ssd(*args, 256)
            torch.autograd.grad(y.float().square().sum(), args)
        counts[S // 256] = dispatched_ops(step)
        torch.cuda.synchronize()
        if (ssd_pass_kernel.launches - k0, ssd_pass_bwd_kernel.launches - b0) \
                != (1, 1):
            raise AssertionError("ops.ssd's forward and backward did not "
                                 "launch K3 and K3b once each")
    log(f"[kernel] ops.ssd forward and backward on the card, aten ops "
        f"dispatched by chunks: {counts}; K3 and K3b once each")
    if len(set(counts.values())) != 1:
        raise AssertionError(f"ops.ssd's op count grows with the chunks: "
                             f"{counts}")
    return max(e for e, _ in worst.values())


def phase_ssd_pass_timings(card):
    """K3 and K3b (bf16) at the train workflow's shape beside their bounds
    (``kernels/cost.py``), their plain versions, and the loop over chunks
    they replaced (its forward, and its backward through autograd)."""
    from repro_torch.kernels.cost import ssd_pass_bwd_cost, ssd_pass_cost
    from repro_torch.kernels.ref import (inter_chunk_y, ssd_pass_bwd_plain,
                                         ssd_pass_plain)
    from repro_torch.kernels.ssd import ssd_chunk_kernel
    from repro_torch.kernels.ssd_pass import ssd_pass_bwd_kernel, ssd_pass_kernel
    B, S, H, P, N, Q = PASS_TRAIN
    x, dt, A, B_, C_ = ssd_inputs(PASS_TRAIN, torch.bfloat16, seed=63)
    terms = ssd_chunk_kernel(x, dt, A, B_, C_, chunk=Q)
    del x, dt, A, B_
    dy = torch.randn((B, S, H, P), device="cuda").to(torch.bfloat16)
    _, _, h_prev = ssd_pass_kernel(*terms, C_, dtype=torch.bfloat16)
    fwd = lambda: ssd_pass_kernel(*terms, C_, dtype=torch.bfloat16)
    bwd = lambda: ssd_pass_bwd_kernel(dy, None, h_prev, terms[2], terms[3],
                                      C_, with_dh0=False)
    t_f = [cuda_ms(fwd, iters=20)]
    t_b = [cuda_ms(bwd, iters=20)]
    plain_f = cuda_ms(lambda: ssd_pass_plain(*terms, C_, dtype=torch.bfloat16),
                      iters=3, warmup=1)
    plain_b = cuda_ms(lambda: ssd_pass_bwd_plain(dy, None, h_prev, terms[2],
                                                 terms[3], C_),
                      iters=3, warmup=1)
    t_f.append(cuda_ms(fwd, iters=20))
    t_b.append(cuda_ms(bwd, iters=20))
    ins = [t.detach().requires_grad_() for t in terms]

    def loop():
        """The parent's recurrence: a loop of plain ops, and autograd."""
        Cr = C_.float().reshape(B, S // Q, Q, N)
        h = torch.zeros((B, H, P, N), device="cuda")
        ys = []
        for c in range(S // Q):
            ys.append(inter_chunk_y(Cr[:, c], ins[2][:, :, c], h))
            h = h * ins[3][:, :, c, None, None] + ins[1][:, :, c]
        y = (ins[0] + torch.stack(ys, dim=1).view(B, S, H, P)).to(dy.dtype)
        torch.autograd.grad(y, ins, dy)
    loop_ms = cuda_ms(loop, iters=3, warmup=1)
    f_cost = ssd_pass_cost(terms[0], terms[1], C_, with_h0=False)
    b_cost = ssd_pass_bwd_cost(dy, h_prev, C_, with_dhT=False, with_dh0=False)
    out = {}
    for name, t, plain, cost in (("ssd_pass_kernel", t_f, plain_f, f_cost),
                                 ("ssd_pass_bwd_kernel", t_b, plain_b,
                                  b_cost)):
        bound_ms, bound_by = bound(*cost)
        ms = sum(t) / 2
        out[name] = {"ms": ms, "plain_ms": plain, "library_ms": None,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "loop_fwd_bwd_ms": loop_ms}
        log(f"[timing] {card}: {name} {PASS_TRAIN} bf16: {t[0]:.4f} / "
            f"{t[1]:.4f} ms; {cost.flops / 1e9:.3f} GFLOP, "
            f"{cost.bytes / 1e6:.2f} MB; bound {bound_ms:.4f} ms "
            f"({bound_by}), {100 * bound_ms / ms:.2f}% of bound; plain "
            f"{plain:.4f} ms; no single PyTorch call computes it")
    log(f"[timing] {card}: the loop over chunks K3 and K3b replace, forward "
        f"and backward through autograd, {PASS_TRAIN}: {loop_ms:.4f} ms")
    return out


def phase_ssd_timings(card):
    from repro_torch.kernels.cost import ssd_chunk_cost
    from repro_torch.kernels.ssd import ssd_chunk_kernel, ssd_chunk_plain
    Q = MAMBA_SHAPE[-1]
    args = ssd_inputs(MAMBA_SHAPE, torch.bfloat16, seed=3)
    ms = cuda_ms(lambda: ssd_chunk_kernel(*args, chunk=Q), iters=20)
    plain_ms = cuda_ms(lambda: ssd_chunk_plain(*args, chunk=Q), iters=5,
                       warmup=1)
    # C B^T once per (b, chunk), M x per (b, h, chunk), the state per
    # (b, h, chunk); 2 flops per multiply-add
    flops, nbytes = ssd_chunk_cost(args[0], args[3], chunk=Q)
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"[timing] {card}: ssd_chunk_kernel {MAMBA_SHAPE} bf16: {ms:.4f} ms; "
        f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB; bound {bound_ms:.4f} "
        f"ms ({bound_by}), {100 * bound_ms / ms:.2f}% of bound; plain "
        f"{plain_ms:.4f} ms; no single PyTorch call computes these terms")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_ssd_bwd_timings(card):
    """K2b (bf16 inputs, f32 cotangents) at the mamba2 shape, its plain
    version, and the backward of the whole ``ops.ssd`` through autograd
    (K2b and the recurrence between chunks; the forward's graph kept and
    only ``torch.autograd.grad`` timed).  The bound counts what the
    function needs: C B^T and dCB's two products once per (b, chunk), dCB
    summed over heads first; G = dy x^T, M^T dy, dS B and dS^T x per (b,
    head, chunk); each input read once (x, B, C in bf16, the rest f32) and
    each output written once (dx in x's type, the rest f32)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.cost import ssd_chunk_bwd_cost
    from repro_torch.kernels.ssd import (ssd_chunk_bwd_kernel,
                                         ssd_chunk_bwd_plain)
    Q = MAMBA_SHAPE[-1]
    args = ssd_inputs(MAMBA_SHAPE, torch.bfloat16, seed=52)
    cts = ssd_cotangents(MAMBA_SHAPE, seed=53)
    kernel = lambda: ssd_chunk_bwd_kernel(*args, *cts, chunk=Q)
    t_k = [cuda_ms(kernel, iters=10)]
    plain_ms = cuda_ms(lambda: ssd_chunk_bwd_plain(*args, *cts, chunk=Q),
                       iters=3, warmup=1)
    t_k.append(cuda_ms(kernel, iters=10))
    ins = [t.detach().requires_grad_() for t in args]
    y, h = ops.ssd(*ins, Q)
    dy = torch.randn(y.shape, device="cuda", dtype=y.dtype,
                     generator=torch.Generator(device="cuda").manual_seed(54))
    dh = torch.zeros_like(h)
    scan_ms = cuda_ms(lambda: torch.autograd.grad((y, h), ins, (dy, dh),
                                                  retain_graph=True), iters=5)
    flops, nbytes = ssd_chunk_bwd_cost(args[0], args[3], chunk=Q)
    bound_ms, bound_by = bound(flops, nbytes)
    ms = sum(t_k) / 2
    log(f"[timing] {card}: ssd_chunk_bwd_kernel {MAMBA_SHAPE} bf16: "
        f"{t_k[0]:.4f} / {t_k[1]:.4f} ms; {flops / 1e9:.3f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB; bound {bound_ms:.4f} ms ({bound_by}), "
        f"{100 * bound_ms / ms:.2f}% of bound; plain {plain_ms:.4f} ms; "
        f"ops.ssd backward through autograd (K2b and the recurrence) "
        f"{scan_ms:.4f} ms; no single PyTorch call computes this backward")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by, "scan_bwd_ms": scan_ms}


def phase_moe(flash, ssd, ssd_pass):
    """The MoE archs.  qwen3-moe-235b-a22b at full width cut to 4 of its 94
    layers (20.59 GiB in bf16): the prefill main path, the serve loop on
    the same params; then, its bf16 params freed, 2 layers in f32 (22.91
    GiB) for prefill against decode.  dbrx-132b at full width cut to 2 of
    its 40 layers (14.44 GiB): the prefill main path.  jamba-1.5-large-398b
    at its reduced config only (16 layers, d_model 64): one full-width
    period of 8 layers is 45.14 B params, 84.07 GiB in bf16, more than the
    card holds, and fewer layers than a period drop its attention layer;
    bf16 prefill (2 K1 and 14 each of K2 and K3 launches), f32 prefill
    against decode, the serve loop."""
    from repro_torch.configs import get_config, reduce_config
    from tools.mamba_sensitivity import published_dt_a
    out = {}
    for arch, layers, seed in ((QWEN, MOE_LAYERS, 21), (DBRX, DBRX_LAYERS, 25)):
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        log(f"[moe] {arch} at full width, depth cut to {layers} of "
            f"{get_config(arch).num_layers} layers: {cfg.param_count()} "
            f"params, {2 * cfg.param_count() / 2**30:.2f} GiB in bf16")
        gc.collect()
        torch.cuda.empty_cache()
        params = smoke_params(cfg, seed)
        out[arch] = dict(phase_moe_prefill(cfg, params, seed + 1),
                         layers=layers, serve_tok_s=None)
        if arch == QWEN:
            out[arch]["serve_tok_s"] = phase_serve(arch, cfg, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        if arch == QWEN:
            cfg32 = dataclasses.replace(cfg, num_layers=MOE_DECODE_LAYERS,
                                        dtype="float32")
            log(f"[moe] {arch} f32, {MOE_DECODE_LAYERS} layers: "
                f"{4 * cfg32.param_count() / 2**30:.2f} GiB")
            phase_moe_prefill_vs_decode(cfg32, seed=23)
            gc.collect()
            torch.cuda.empty_cache()

    cfg = reduce_config(get_config(JAMBA))
    log(f"[moe] {JAMBA} at its reduced config ({cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.num_experts} experts top-"
        f"{cfg.num_experts_per_tok}): the width is reduced because one "
        "full-width period of 8 layers is 84.07 GiB in bf16")
    # attention rescaled as smoke_params does, dt and A drawn as Mamba2's
    # published init draws them (mamba_smoke_params): the conditioning
    # that lets PREFILL_TOL tell a fault from rounding in either kind
    params = published_dt_a(smoke_params(cfg, 27), 27)
    out[JAMBA] = dict(phase_prefill(cfg, params, [flash, ssd, ssd_pass],
                                    seed=28),
                      layers=cfg.num_layers)
    del params
    cfg32 = dataclasses.replace(
        cfg, dtype="float32",
        capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    phase_prefill_vs_decode(cfg32, smoke_params(cfg32, 29), B=2, S=32, seed=30)
    out[JAMBA]["serve_tok_s"] = phase_serve(JAMBA, reduced=True)
    return out


def check_train_layers(cfg, params, batch, what):
    """One loss and grad with each attention layer's K1 (o and lse, the
    forward and its recompute under remat "full") and K1b held against
    their plain versions on that layer's own inputs: the main path's
    activations and cotangents.  K1 by ``check_fwd``, K1b within BWD_TOL
    and normwise BWD_NORM_TOL, as on random inputs.  Returns the largest
    |kernel - plain| of each."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (flash_attention_bwd_plain,
                                         flash_attention_lse_plain)
    from repro_torch.models import model as M
    real = {"lse": ops.flash_attention_lse, "grads": ops.flash_attention_grads}
    errs = {"lse": [], "grads": []}

    def lse(q, k, v, **kw):
        o, l = real["lse"](q, k, v, **kw)
        want_o, want_l = flash_attention_lse_plain(q, k, v, **kw)
        r = check_fwd(f"{what} layer {len(errs['lse']) // 2}", o, want_o, l,
                      want_l)
        errs["lse"].append((max(r["o"], r["lse"]), r["normwise"]))
        return o, l

    def grads(q, k, v, o, l, do, **kw):
        got = real["grads"](q, k, v, o, l, do, **kw)
        want = flash_attention_bwd_plain(q, k, v, o, l, do, **kw)
        worst = (0.0, 0.0)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err, ok = max_excess(g, w, BWD_TOL[q.dtype])
            rel = norm_error(g, w)
            if not (ok and rel <= BWD_NORM_TOL[q.dtype]):
                raise AssertionError(
                    f"{what} layer {len(errs['grads'])}: K1b {name} max "
                    f"|kernel-plain| {err}, normwise {rel}")
            worst = (max(worst[0], err), max(worst[1], rel))
        errs["grads"].append(worst)
        return got

    ops.flash_attention_lse, ops.flash_attention_grads = lse, grads
    try:
        out, _ = M.make_loss_and_grad(cfg)(params, batch)
        torch.cuda.synchronize()
    finally:
        ops.flash_attention_lse, ops.flash_attention_grads = (real["lse"],
                                                              real["grads"])
    del out
    n_attn = expected_launches(cfg, train=True)["flash_attention_bwd"]
    if (len(errs["lse"]), len(errs["grads"])) != (2 * n_attn, n_attn):
        raise AssertionError(f"{what}: {len(errs['lse'])} K1 and "
                             f"{len(errs['grads'])} K1b calls checked")
    fwd, bwd = (max(e[0] for e in errs[n]) for n in ("lse", "grads"))
    log(f"[train] {what} per layer, on the layers' own inputs: K1 with lse "
        f"vs plain ({len(errs['lse'])} calls) max |diff| {fwd:.4g} (tol "
        f"{TOL[torch.bfloat16]}), o normwise "
        f"{max(e[1] for e in errs['lse']):.4g} (tol "
        f"{FWD_NORM_TOL[torch.bfloat16]}), lse within {LSE_TOL}; K1b vs plain ({len(errs['grads'])} calls) "
        f"max |diff| {bwd:.4g} (tol {BWD_TOL[torch.bfloat16]}), normwise "
        f"{max(e[1] for e in errs['grads']):.4g} (tol "
        f"{BWD_NORM_TOL[torch.bfloat16]})")
    gc.collect()
    torch.cuda.empty_cache()
    return {"fwd": fwd, "bwd": bwd}


def train_steps(card, cfg, params, batch, steps, what, falling=True):
    """A main path: ``make_train_step`` with AdamW (remat "full") on the
    train driver's schedule (``launch.train.build_state``: 3e-4 after 20
    warm-up steps), ``steps`` steps on one batch, each timed with its
    launches counted from 0: K1 twice and K1b once per attention layer a
    step, nothing else; the loss finite every step and, with ``falling``,
    lower at the last step than at the first.  Before the steps, each
    layer's K1 and K1b against their plain versions on the path's own
    inputs (``check_train_layers``).  Returns step ms (mean after the
    first), tokens/s, peak and the per-layer errors."""
    from repro_torch.models import model as M
    from repro_torch.optim import AdamW, cosine_schedule
    n = param_count(params)
    layer_err = check_train_layers(cfg, params, batch, what)
    opt = AdamW(lr=cosine_schedule(3e-4, 20, 10_000))
    state = opt.init(params)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, state, losses, metrics, times, counts = timed_steps(
        M.make_train_step(cfg, opt), params, state, batch, steps)
    peak = torch.cuda.max_memory_allocated()
    want = expected_launches(cfg, train=True)
    step_ms = sum(times[1:]) / (len(times) - 1)
    tokens = batch["tokens"].numel()
    tok_s = tokens / (step_ms / 1e3)
    log(f"[train] {what} ({n} params, {cfg.num_layers} layers) bf16 "
        f"B={batch['tokens'].shape[0]} S={batch['tokens'].shape[1]}"
        + (f" after {batch['patches'].shape[1]} patch positions"
           if "patches" in batch else "")
        + f", remat {cfg.remat}, {steps} AdamW steps on one batch: losses "
        f"{losses}, grad norm at the last {float(metrics['grad_norm']):.4g}; "
        f"launches per step {counts[0]} (expected {want}); step ms "
        + ", ".join(f"{t:.3f}" for t in times)
        + f" (mean after the first {step_ms:.3f}, {tok_s:.0f} tokens/s); peak "
        f"{peak / 2**30:.3f} GiB ({card})")
    if any(c != want for c in counts):
        raise AssertionError(f"{what} train steps launched {counts}, "
                             f"expected {want} each")
    if not (all(np.isfinite(losses))
            and np.isfinite(float(metrics["grad_norm"]))
            and (losses[-1] < losses[0] or not falling)):
        raise AssertionError(f"{what} train losses {losses}: not finite"
                             + (" or not falling" if falling else ""))
    del state, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "per_step": counts[0], "step_ms": step_ms,
            "times": times, "tok_s": tok_s, "peak_bytes": peak, "params": n,
            "layer_err": layer_err}


def phase_gemma(card, flash):
    """gemma2-9b: 42 layers alternating local (the 4096 window, even
    layers) and global attention, head dim 256, attention cap 50, logit
    cap 30, V=256000, tied head; random weights (``smoke_params``).

    At full width and depth (9.241 B params, 17.21 GiB in bf16): the
    prefill main path at B=1, S=8192 (42 K1 launches at D=256, the window
    cutting on the 21 local layers; K1 against its plain version in every
    layer and the logits against the plain route) and the serve loop.  At
    2 layers in f32 (one local, one global): prefill against 4352
    token-by-token decode steps, past the window, so decode's window mask
    runs; loss and grad by the kernel route against the plain route at
    B=1, S=6144.  At 4 layers (two local, two global) in bf16: the train
    main path at B=1, S=8192 (8 K1 and 4 K1b launches a step; the
    embedding's 917 M elements take AdamW's sliced path, the loss four
    chunks of 2048 over V)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ref import (flash_attention_bwd_plain,
                                         flash_attention_lse_plain)
    from repro_torch.models import transformer as T
    cfg = get_config(GEMMA)
    kinds = [kind for kind, _ in T.layer_program(cfg)]
    log(f"[gemma] {GEMMA} at full width and depth: {cfg.param_count()} "
        f"params, {2 * cfg.param_count() / 2**30:.2f} GiB in bf16; "
        f"{kinds.count('local_attn')} local layers (window "
        f"{cfg.sliding_window}) and {kinds.count('attn')} global, head dim "
        f"{cfg.head_dim}, caps {cfg.attn_softcap} (attention) and "
        f"{cfg.logit_softcap} (logits)")
    gc.collect()
    torch.cuda.empty_cache()
    params = smoke_params(cfg, 31)
    pre = phase_prefill(cfg, params, [flash], 32, B=GEMMA_B, S=GEMMA_S,
                        iters=5)
    del pre["batch"], pre["logits"]
    pre["serve_tok_s"] = phase_serve(GEMMA, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, num_layers=GEMMA_F32_LAYERS,
                                dtype="float32")
    phase_prefill_vs_decode(cfg32, smoke_params(cfg32, 33), B=1,
                            S=GEMMA_DECODE_S, seed=34)
    gc.collect()
    torch.cuda.empty_cache()
    route = route_compare(
        f"{GEMMA} f32 {GEMMA_F32_LAYERS} layers B=1 S={GEMMA_ROUTE_S}",
        cfg32, smoke_params(cfg32, 35), train_batch(cfg32, 1, GEMMA_ROUTE_S, 36),
        {"flash_attention_lse": flash_attention_lse_plain,
         "flash_attention_grads": flash_attention_bwd_plain})
    gc.collect()
    torch.cuda.empty_cache()

    cfg4 = dataclasses.replace(cfg, num_layers=GEMMA_TRAIN_LAYERS)
    log(f"[gemma] {GEMMA} training at full width cut to "
        f"{GEMMA_TRAIN_LAYERS} layers: {cfg4.param_count()} params, "
        f"{(2 + 2 + 8) * cfg4.param_count() / 1e9:.1f} GB of bf16 params "
        "and grads and f32 moments")
    params = smoke_params(cfg4, 37)
    train = train_steps(card, cfg4, params, train_batch(cfg4, GEMMA_B, GEMMA_S,
                                                        38),
                        GEMMA_TRAIN_STEPS,
                        f"{GEMMA} ({GEMMA_TRAIN_LAYERS} layers)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"prefill": pre, "route": route, "train": train}


def phase_vlm(card, flash):
    """internvl2-76b at full width (d_model 8192, 64 q heads on 8 kv heads
    of 128, d_ff 28672, V=128256, untied head) cut in depth: 80 layers are
    about 70 B params, more than one card holds (ROADMAP item 13).

    At 4 layers (5.658 B params, 10.54 GiB in bf16): the prefill main path
    at B=4 with 1024 patch positions (its frontend_tokens, through the
    connector MLP) in front of 1024 text tokens, 4 K1 launches, kernel
    route against plain route.  At 1 layer (3.091 B params, 37.1 GB of
    params, grads and f32 moments) on the same shape: one loss and grad
    (K1 twice, K1b once; every grad leaf finite, the connector's nonzero;
    the loss equal to ``lm_loss`` over the text positions' hidden states
    alone), then AdamW steps.  Then the train driver on the reduced
    config, its data pipeline's patches reaching ``loss_fn`` on the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves
    full = get_config(VLM)
    nfe = full.frontend_tokens
    cfg = dataclasses.replace(full, num_layers=VLM_LAYERS)
    log(f"[vlm] {VLM} at full width, depth cut to {VLM_LAYERS} of "
        f"{full.num_layers} layers: {cfg.param_count()} params, "
        f"{2 * cfg.param_count() / 2**30:.2f} GiB in bf16; {nfe} patch "
        "positions a sequence")
    gc.collect()
    torch.cuda.empty_cache()
    params = smoke_params(cfg, 41)
    pre = phase_prefill(cfg, params, [flash], 42, B=VLM_B, S=PREFILL_S,
                        patches=nfe)
    del pre["batch"], pre["logits"], params
    gc.collect()
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(full, num_layers=VLM_TRAIN_LAYERS)
    params = smoke_params(cfg, 43)
    rng = np.random.default_rng(44)
    batch = train_batch(cfg, VLM_B, PREFILL_S, 44)
    batch["patches"] = patch_batch(cfg, VLM_B, nfe, rng)
    with torch.no_grad():
        loss, _ = M.loss_fn(cfg, params, batch)
        hidden, _, _ = T.forward(cfg, params, M.embed_inputs(cfg, params,
                                                             batch),
                                 mode="train")
        text = M.lm_loss(cfg, params, hidden[:, nfe:], batch["targets"],
                         batch["loss_mask"])
        del hidden
    reset_launches()                            # the main path starts here
    grads, metrics = M.make_loss_and_grad(cfg)(params, batch)
    torch.cuda.synchronize()
    counts = read_launches()                    # ... and ends here
    want = expected_launches(cfg, train=True)
    finite = all(bool(torch.isfinite(g).all()) for g in leaves(grads))
    conn = {k: float(g.float().abs().max())
            for k, g in grads["connector"].items()}
    del grads
    log(f"[vlm] {VLM} at {VLM_TRAIN_LAYERS} layer ({param_count(params)} "
        f"params), bf16 B={VLM_B}, {nfe} patch positions and {PREFILL_S} "
        f"text tokens: loss and grad launches {counts} (expected {want}), "
        f"loss {float(metrics['loss']):.5f} (without grad {float(loss):.5f}; "
        f"lm_loss over the text positions alone {float(text):.5f}), every "
        f"grad leaf finite {finite}, connector max |grad| {conn}")
    if counts != want or not finite or not all(v > 0 for v in conn.values()):
        raise AssertionError(f"{VLM} loss and grad: launches {counts}, "
                             f"finite {finite}, connector {conn}")
    if float(loss) != float(text) or not np.isfinite(float(metrics["loss"])):
        raise AssertionError(f"{VLM}: loss {float(loss)} is not lm_loss over "
                             f"the text positions {float(text)}")
    trained = train_steps(card, cfg, params, batch, VLM_TRAIN_STEPS,
                          f"{VLM} ({VLM_TRAIN_LAYERS} layer)", falling=False)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()

    seen = []
    real = M.loss_fn

    def spy(cfg, params, batch, *a, **kw):
        seen.append((tuple(batch["patches"].shape), batch["patches"].device.type))
        return real(cfg, params, batch, *a, **kw)
    ckpt = ROOT / "build" / "chip_smoke_ckpt_vlm"
    shutil.rmtree(ckpt, ignore_errors=True)
    M.loss_fn = spy
    try:
        reset_launches()                        # the main path starts here
        d_losses = train.main(VLM_DRIVER_ARGV + ["--ckpt-dir", str(ckpt)])
        torch.cuda.synchronize()
        d_counts = read_launches()              # ... and ends here
    finally:
        M.loss_fn = real
        shutil.rmtree(ckpt, ignore_errors=True)
    L = 2                                       # the reduced config's layers
    d_want = {"flash_attention_fwd": 2 * L * 4 + L, "flash_attention_bwd": 4 * L,
              "ssd_chunk_kernel": 0, "ssd_chunk_bwd_kernel": 0,
              "ssd_pass_kernel": 0, "ssd_pass_bwd_kernel": 0}
    log(f"[vlm] {VLM} reduced, train driver 4 steps in 2 segments through "
        f"the runtime: losses {d_losses}, launches {d_counts} (expected "
        f"{d_want}); loss_fn saw patches {sorted(set(seen))}")
    if d_counts != d_want or len(d_losses) != 2 or not all(
            np.isfinite(d_losses)) or len(seen) != 5 or any(
            dev != "cuda" or shape[1] != 4 for shape, dev in seen):
        raise AssertionError(f"{VLM} driver: losses {d_losses}, launches "
                             f"{d_counts}, patches {seen}")
    return {"prefill": pre, "train": trained, "loss_and_grad": counts}


def phase_dense_archs(card, flash):
    """musicgen-large (48 layers, MHA: 32 q heads on 32 kv heads of 64, a
    non-gated GELU MLP, V=2048), granite-3-2b (40 layers, 32 on 8 of 64,
    V=49155, tied) and internlm2-1.8b (24 layers, 16 on 8 of 128, V=92544,
    untied), each at full width with ``smoke_params``: the prefill main
    path (bf16, B=8, S=1024, K1 once a layer, kernel route against plain
    route), the serve loop, and the train main path on the same params
    (B=8, S=1024, remat "full", AdamW, K1 twice and K1b once a layer a
    step, the loss falling); each cut to DENSE_TRAIN_LAYERS layers
    throughout.  Then the train driver on internlm2 at the same cut, 2
    segments of 2 steps through the runtime."""
    from repro_torch.configs import get_config
    out = {}
    for i, arch in enumerate(DENSE):
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, num_layers=DENSE_TRAIN_LAYERS.get(
            arch, cfg.num_layers))
        log(f"[dense] {arch} at full width, {cfg.num_layers} layers: "
            f"{cfg.param_count()} params, {cfg.num_heads} q heads on "
            f"{cfg.num_kv_heads} kv heads of {cfg.head_dim}, V="
            f"{cfg.vocab_size}, {'tied' if cfg.tie_embeddings else 'untied'} "
            f"head; {(2 + 2 + 8) * cfg.param_count() / 1e9:.1f} GB to train")
        gc.collect()
        torch.cuda.empty_cache()
        seed = 51 + 4 * i
        params = smoke_params(cfg, seed)
        pre = phase_prefill(cfg, params, [flash], seed + 1)
        del pre["batch"], pre["logits"]
        pre["serve_tok_s"] = phase_serve(arch, cfg, params)
        pre["train"] = train_steps(
            card, cfg, params,
            train_batch(cfg, PREFILL_B, PREFILL_S, seed + 2),
            DENSE_TRAIN_STEPS, arch)
        out[arch] = pre
        del params
        gc.collect()
        torch.cuda.empty_cache()

    out["driver"] = driver_run(
        dataclasses.replace(get_config(DENSE_DRIVER),
                            num_layers=DENSE_TRAIN_LAYERS[DENSE_DRIVER]),
        DENSE_DRIVER_ARGV, "chip_smoke_ckpt_dense", "flash_attention_bwd")
    return out


def phase_window_timings(card):
    """K1 and K1b (bf16) at gemma2-9b's local-layer attention (B=1, S=8192,
    Hq=16, Hkv=8, D=256, the 4096 window, cap 50), each beside SDPA's
    forward or backward given the window as a boolean mask (no cap: SDPA
    has none; k and v repeated to the q heads beforehand, untimed, so that
    a masked kernel takes them), in turns, and the plain versions.  The
    work counts the (q, k) pairs the window keeps: W(W+1)/2 + (S-W)W per
    head, 75% of causal at S=8192; two products a pair forward, the five a
    backward needs."""
    import torch.nn.functional as F
    from repro_torch.kernels.cost import (attention_pairs, flash_bwd_cost,
                                          flash_fwd_cost)
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_fwd,
                                                     flash_attention_plain)
    S, Hq, Hkv = GEMMA_SHAPE[1:4]
    W = GEMMA_WINDOW
    q, k, v = qkv(GEMMA_SHAPE, torch.bfloat16, seed=19)
    do = qkv(GEMMA_SHAPE, torch.bfloat16, seed=21)[0]
    kw = dict(causal=True, window=W, attn_softcap=GEMMA_CAP)
    o, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
    i = torch.arange(S, device="cuda")
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - W)
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
              for t in (k, v))
    lib_fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                     attn_mask=mask)
    # the library computes the same function as the kernel without the cap
    err, ok = max_excess(lib_fwd().transpose(1, 2),
                         flash_attention_fwd(q, k, v, causal=True, window=W),
                         TOL[torch.bfloat16])
    if not ok:
        raise AssertionError(f"SDPA with the window mask is not K1 without "
                             f"the cap: {err}")
    grad_in = [t.detach().requires_grad_() for t in (qt, kt, vt)]
    out = F.scaled_dot_product_attention(*grad_in, attn_mask=mask)
    dot = do.transpose(1, 2)
    lib_bwd = lambda: torch.autograd.grad(out, grad_in, dot, retain_graph=True)
    pairs = attention_pairs(S, S, window=W)
    res = {}
    for name, kern, lib, plain, products, (flops, nbytes) in (
            ("fwd", lambda: flash_attention_fwd(q, k, v, **kw), lib_fwd,
             lambda: flash_attention_plain(q, k, v, **kw), 2,
             flash_fwd_cost(q, k, causal=True, window=W)),
            ("bwd", lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw),
             lib_bwd,
             lambda: flash_attention_bwd_plain(q, k, v, o, lse, do, **kw), 5,
             flash_bwd_cost(q, k, causal=True, window=W))):
        t_k, t_l = in_turns(kern, lib, iters=10)
        plain_ms = cuda_ms(plain, iters=2, warmup=1)
        torch.cuda.empty_cache()
        bound_ms, bound_by = bound(flops, nbytes)
        ms = sum(t_k) / 2
        res[name] = {"ms": ms, "plain_ms": plain_ms,
                     "library_ms": sum(t_l) / 2, "bound_ms": bound_ms,
                     "bound_by": bound_by}
        log(f"[timing] {card}: flash_attention_{name} D=256 {GEMMA_SHAPE} "
            f"bf16 window {W} cap {GEMMA_CAP} (gemma2's local layers): "
            f"{t_k[0]:.4f} / {t_k[1]:.4f} ms; {pairs} of {S * (S + 1) // 2} "
            f"causal pairs a head kept, {flops / 1e9:.3f} GFLOP ({products} "
            f"products), {nbytes / 1e6:.2f} MB; bound {bound_ms:.4f} ms "
            f"({bound_by}), {100 * bound_ms / ms:.2f}% of bound; plain "
            f"{plain_ms:.4f} ms; scaled_dot_product_attention {name} with "
            f"the window as a boolean mask (no cap; its forward {err:.3g} "
            f"from K1 without the cap) {t_l[0]:.4f} / {t_l[1]:.4f} ms (in "
            "turns: kernel, library, library, kernel)")
    return res


def phase_arch_timings(card):
    """K1 and K1b (bf16, causal) at the attention shapes of musicgen,
    granite and internlm2 (B=8, S=1024) and internvl2 (B=4, S=2048: 1024
    patch positions and 1024 text tokens), each beside SDPA's forward and
    backward and its plain version; K1 and K1b at gemma2's local layers
    with the window."""
    from repro_torch.configs import get_config
    out = {}
    for arch, B, S in ((a, PREFILL_B, PREFILL_S) for a in DENSE):
        c = get_config(arch)
        shape = (B, S, c.num_heads, c.num_kv_heads, c.head_dim)
        out[arch] = {"fwd": phase_timings(card, shape),
                     "bwd": bwd_timing(card, shape, seed=61)}
    c = get_config(VLM)
    shape = (VLM_B, PREFILL_S + c.frontend_tokens, c.num_heads,
             c.num_kv_heads, c.head_dim)
    out[VLM] = {"fwd": phase_timings(card, shape),
                "bwd": bwd_timing(card, shape, seed=63)}
    out[f"{GEMMA} local"] = phase_window_timings(card)
    return out


def sdpa_at_offset(q, k, v, do, kw, iters):
    """SDPA's forward and backward on a rank's chunk of q at
    ``kw["q_offset"]``: a boolean mask of the (q, k) pairs its rows see
    (key j for row i when j <= i + offset, and j > i + offset - window with
    a window), k and v repeated to the q heads beforehand, untimed; no cap
    (SDPA has none).  Each timed in turns with K1 or K1b on the same chunk
    (with its cap): {"fwd" / "bwd": (kernel ms, library ms)}, each the mean
    of two, and SDPA's forward against K1 without the cap, which computes
    the same function."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    Sq, Skv, Hq, Hkv = q.shape[1], k.shape[1], q.shape[2], k.shape[2]
    off, W = kw["q_offset"], kw["window"]
    i = torch.arange(Sq, device=q.device)[:, None] + off
    j = torch.arange(Skv, device=q.device)[None, :]
    mask = (j <= i) & ((j > i - W) if W else True)
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
              for t in (k, v))
    lib_fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                     attn_mask=mask)
    err, ok = max_excess(lib_fwd().transpose(1, 2), flash_attention_fwd(
        q, k, v, **dict(kw, attn_softcap=0.0)), TOL[q.dtype])
    if not ok:
        raise AssertionError(f"SDPA with the offset mask is not K1 without "
                             f"the cap: {err}")
    o, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
    grad_in = [t.detach().requires_grad_() for t in (qt, kt, vt)]
    out = F.scaled_dot_product_attention(*grad_in, attn_mask=mask)
    dot = do.transpose(1, 2)
    res = {"sdpa_err": err}
    for name, kern, lib in (
            ("fwd", lambda: flash_attention_fwd(q, k, v, with_lse=True, **kw),
             lib_fwd),
            ("bwd", lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw),
             lambda: torch.autograd.grad(out, grad_in, dot,
                                         retain_graph=True))):
        t_k, t_l = in_turns(kern, lib, iters)
        res[name] = (sum(t_k) / 2, sum(t_l) / 2)
    del out, grad_in, kt, vt, mask
    torch.cuda.empty_cache()
    return res


def seq_rank_check(what, q, k, v, do, M, kw, iters):
    """The "seq" strategy's per-rank bodies at one shape: for each rank r of
    M, K1 (o and lse) and K1b on q's chunk r at ``q_offset = r S/M``
    against the whole of k and v, each against its plain version (K1 by
    ``check_fwd``, K1b within BWD_TOL and BWD_NORM_TOL, run twice and
    bitwise equal); then the chunks' o and dq side by side and the sum of
    their dk, dv against the unsharded K1 and K1b on the whole of q, under
    the same gates.  Each rank's K1 and K1b time beside the unsharded
    call's, and the last rank's beside SDPA with the offset as a mask
    (``sdpa_at_offset``).  Returns the worst |kernel - plain| and the
    times."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_fwd,
                                                     flash_attention_lse_plain)
    S = q.shape[1]
    chunk, worst = S // M, 0.0

    def check_grads(label, got, want):
        nonlocal worst
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err, ok = max_excess(g, w, BWD_TOL[q.dtype])
            rel = norm_error(g, w)
            if not (ok and rel <= BWD_NORM_TOL[q.dtype]
                    and bool(torch.isfinite(g).all())):
                raise AssertionError(
                    f"flash_attention_bwd {what} {label}: {name} max "
                    f"|kernel-plain| {err} (tol {BWD_TOL[q.dtype]}), "
                    f"normwise {rel} (tol {BWD_NORM_TOL[q.dtype]})")
            worst = max(worst, err)

    o_all, lse_all = flash_attention_fwd(q, k, v, with_lse=True, **kw)
    g_all = flash_attention_bwd(q, k, v, o_all, lse_all, do, **kw)
    t_fwd = cuda_ms(lambda: flash_attention_fwd(q, k, v, with_lse=True, **kw),
                    iters=iters)
    t_bwd = cuda_ms(lambda: flash_attention_bwd(q, k, v, o_all, lse_all, do,
                                                **kw), iters=iters)
    parts, dk, dv, ranks = [], 0.0, 0.0, []
    for r in range(M):
        sl = slice(r * chunk, (r + 1) * chunk)
        qr, dor = q[:, sl].contiguous(), do[:, sl].contiguous()
        c = dict(kw, q_offset=r * chunk)
        f0, b0 = flash_attention_fwd.launches, flash_attention_bwd.launches
        o, lse = flash_attention_fwd(qr, k, v, with_lse=True, **c)
        got = flash_attention_bwd(qr, k, v, o, lse, dor, **c)
        again = flash_attention_bwd(qr, k, v, o, lse, dor, **c)
        torch.cuda.synchronize()
        if (flash_attention_fwd.launches - f0,
                flash_attention_bwd.launches - b0) != (1, 2):
            raise AssertionError(f"{what} rank {r}: a call did not launch "
                                 "its kernel")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd {what} rank {r} at "
                                 f"q_offset {r * chunk}: two runs differ")
        want_o, want_lse = flash_attention_lse_plain(qr, k, v, **c)
        rd = check_fwd(f"{what} rank {r} q_offset {r * chunk}", o, want_o,
                       lse, want_lse)
        worst = max(worst, rd["o"], rd["lse"])
        del want_o, want_lse
        check_grads(f"rank {r} q_offset {r * chunk}", got,
                    flash_attention_bwd_plain(qr, k, v, o, lse, dor, **c))
        ranks.append({
            "q_offset": r * chunk,
            "fwd_ms": cuda_ms(lambda: flash_attention_fwd(
                qr, k, v, with_lse=True, **c), iters=iters),
            "bwd_ms": cuda_ms(lambda: flash_attention_bwd(
                qr, k, v, o, lse, dor, **c), iters=iters)})
        if r == M - 1:
            ranks[-1]["sdpa"] = sdpa_at_offset(qr, k, v, dor, c, iters)
            ranks[-1]["plain_ms"] = {
                "fwd": cuda_ms(lambda: flash_attention_lse_plain(
                    qr, k, v, **c), iters=2, warmup=1),
                "bwd": cuda_ms(lambda: flash_attention_bwd_plain(
                    qr, k, v, o, lse, dor, **c), iters=2, warmup=1)}
        parts.append((o, got[0]))
        dk, dv = dk + got[1].float(), dv + got[2].float()
        torch.cuda.empty_cache()
    rd = check_fwd(f"{what} chunks side by side against the whole",
                   torch.cat([p[0] for p in parts], 1), o_all)
    worst = max(worst, rd["o"])
    check_grads("sum over ranks against the whole",
                (torch.cat([p[1] for p in parts], 1), dk, dv), g_all)
    sdpa = ranks[-1]["sdpa"]
    log(f"[seq] {what}, M={M}: " + ", ".join(
        f"rank {i} (q_offset {x['q_offset']}) K1 {x['fwd_ms']:.4f} ms, K1b "
        f"{x['bwd_ms']:.4f} ms" for i, x in enumerate(ranks))
        + f"; unsharded K1 {t_fwd:.4f} ms, K1b {t_bwd:.4f} ms; rank {M - 1} "
        f"in turns with scaled_dot_product_attention given its pairs as a "
        f"boolean mask (no cap; its forward {sdpa['sdpa_err']:.3g} from K1 "
        f"without the cap): K1 {sdpa['fwd'][0]:.4f} ms, SDPA "
        f"{sdpa['fwd'][1]:.4f} ms; K1b {sdpa['bwd'][0]:.4f} ms, SDPA's "
        f"backward {sdpa['bwd'][1]:.4f} ms; its plain versions K1 "
        f"{ranks[-1]['plain_ms']['fwd']:.4f} ms, K1b "
        f"{ranks[-1]['plain_ms']['bwd']:.4f} ms")
    return worst, {"M": M, "ranks": ranks, "unsharded_fwd_ms": t_fwd,
                   "unsharded_bwd_ms": t_bwd}


def phase_seq_shards(card):
    """The "seq" strategy of ``sharded_flash_attention`` (a model axis of M
    ranks, each with a contiguous chunk of q at ``q_offset = r S/M``
    against the whole of k and v) on the card, one process: each rank's
    body through K1 and K1b at full width, smollm-360m's attention (B=8,
    S=1024, 15 q heads on 5, D=64, bf16, causal), whose heads divide
    neither way on a model axis of 2 or 4, with M = 2 and 4; and gemma2-9b's
    (B=1, S=8192, 16 on 8, D=256, cap 50) with M = 2 for a global layer and
    a window-4096 layer: the wgmma family with its TMA reads at an offset
    of 4096 (``seq_rank_check``)."""
    out, worst = {}, 0.0
    q, k, v = qkv(TRAIN_SHAPE, torch.bfloat16, seed=31)
    do = qkv(TRAIN_SHAPE, torch.bfloat16, seed=32)[0]
    for M in (2, 4):
        e, out[f"smollm M={M}"] = seq_rank_check(
            f"smollm-360m {TRAIN_SHAPE}", q, k, v, do, M,
            dict(causal=True, window=0, attn_softcap=0.0), iters=10)
        worst = max(worst, e)
    del q, k, v, do
    q, k, v = qkv(GEMMA_SHAPE, torch.bfloat16, seed=33)
    do = qkv(GEMMA_SHAPE, torch.bfloat16, seed=34)[0]
    for window in (0, GEMMA_WINDOW):
        e, out[f"gemma2 window={window} M=2"] = seq_rank_check(
            f"gemma2-9b {GEMMA_SHAPE} window={window} cap={GEMMA_CAP}", q, k,
            v, do, 2, dict(causal=True, window=window,
                           attn_softcap=GEMMA_CAP), iters=5)
        worst = max(worst, e)
    del q, k, v, do
    torch.cuda.empty_cache()
    log(f"[seq] {card}: every rank's K1 and K1b within their gates "
        f"(worst |kernel - plain| {worst:.3g})")
    return worst, out


@contextlib.contextmanager
def one_rank_world():
    """A world of one rank on the card (NCCL), through a FileStore under
    build/ in the checkout; ended on the way out."""
    import torch.distributed as dist
    store = ROOT / "build" / "mesh_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        if store.exists():
            store.unlink()


def phase_mesh(card):
    """The model on a one-rank ``DeviceMesh`` (NCCL, world size 1), driven
    through the normal step factories with ``ShardCtx(make_local_mesh(1,
    1))``: params and moments DTensors, the model's ops on DTensors, the
    kernels inside ``local_map`` regions.  smollm-360m's train step at full
    width and depth (bf16, B=8, S=1024, AdamW, 3 steps) and mamba2-1.3b's
    prefill at full width (B=8, S=1024, through ``sharded_ssd``); then an
    f32 loss and grad of smollm-360m cut to 4 layers by both.  Gates: the
    exact launch counts of the unsharded paths (64 K1 and 32 K1b a train
    step; 48 K2 a prefill), counted from 0 around each main path; the
    same unsharded steps' losses (bf16 within PREFILL_TOL) and logits
    (PREFILL_TOL); the f32 loss within ROUTE_LOSS_TOL and every grad leaf
    within ROUTE_GRAD_TOL; every param, moment and grad leaf a DTensor
    on cuda.  Each step's time beside the unsharded one's."""
    from torch.distributed.tensor import DTensor

    from repro_torch import params as P
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.sharding import ShardCtx
    from repro_torch.tree import leaves

    def on_card(tree, what):
        bad = [t for t in leaves(tree) if not (isinstance(t, DTensor)
                                                and t.device.type == "cuda")]
        if bad:
            raise AssertionError(f"mesh: {len(bad)} {what} leaves are not "
                                 "DTensors on cuda")

    out = {}
    with one_rank_world():
        sctx = ShardCtx(make_local_mesh(1, 1))
        cfg = get_config("smollm-360m")
        batch = train_batch(cfg, PREFILL_B, PREFILL_S, 41)
        runs = {}
        for name, ctx in (("unsharded", None), ("mesh", sctx)):
            params = smoke_params(cfg, 40)
            if ctx is not None:
                params = P.shard_tree(params, cfg, ctx.mesh)
            opt = AdamW(lr=cosine_schedule(3e-4, 20, 10_000))
            state = opt.init(params)
            step = (M.make_train_step(cfg, opt) if ctx is None
                    else M.make_train_step(cfg, opt, ctx))
            params, state, losses, _, times, counts = timed_steps(
                step, params, state, batch, 3)
            want = expected_launches(cfg, train=True)
            if any(c != want for c in counts):
                raise AssertionError(f"mesh: smollm-360m {name} train step "
                                     f"launched {counts}, expected {want}")
            if ctx is not None:
                on_card(params, "param")
                on_card(state.m, "moment")
            runs[name] = {"losses": losses, "step_ms": times}
            del params, state, step, opt
            gc.collect()
            torch.cuda.empty_cache()
        diff = max(abs(a - b) for a, b in zip(runs["mesh"]["losses"],
                                              runs["unsharded"]["losses"]))
        if not diff <= PREFILL_TOL:
            raise AssertionError(f"mesh: smollm-360m train losses "
                                 f"{runs['mesh']['losses']} against "
                                 f"{runs['unsharded']['losses']}")
        log(f"[mesh] {card}: smollm-360m train step on a 1x1 DeviceMesh, bf16 "
            f"B={PREFILL_B} S={PREFILL_S}: losses {runs['mesh']['losses']} "
            f"against unsharded {runs['unsharded']['losses']} (|diff| "
            f"{diff:.3g}, tol {PREFILL_TOL}); step "
            + " / ".join(f"{t:.3f}" for t in runs["mesh"]["step_ms"])
            + " ms on the mesh, "
            + " / ".join(f"{t:.3f}" for t in runs["unsharded"]["step_ms"])
            + f" ms unsharded; launches a step {want}")
        out["train"] = dict(runs, loss_diff=diff, launches=want)

        # f32 loss and grad at 4 layers: the strict gates
        cfg32 = dataclasses.replace(cfg, dtype="float32",
                                    num_layers=ROUTE_LAYERS)
        params = smoke_params(cfg32, 42)
        b32 = train_batch(cfg32, ROUTE_B, ROUTE_S, 43)
        want_g, want_m = M.make_loss_and_grad(cfg32)(params, b32)
        got_g, got_m = M.make_loss_and_grad(cfg32, sctx)(
            P.shard_tree(params, cfg32, sctx.mesh), b32)
        on_card(got_g, "grad")
        loss_err = abs(float(got_m["loss"]) - float(want_m["loss"]))
        worst = 0.0
        for g, w in zip(leaves(P.gather_tree(got_g)), leaves(want_g)):
            worst = max(worst, float((g.float() - w.float()).abs().max()
                                     / w.float().abs().max().clamp_min(1e-30)))
        log(f"[mesh] smollm-360m f32 {ROUTE_LAYERS} layers B={ROUTE_B} "
            f"S={ROUTE_S}: loss {float(got_m['loss']):.6f} on the mesh, "
            f"{float(want_m['loss']):.6f} unsharded (|diff| {loss_err:.3g}, "
            f"tol {ROUTE_LOSS_TOL}); every grad leaf within {worst:.3g} of "
            f"its largest magnitude (tol {ROUTE_GRAD_TOL})")
        if not (loss_err <= ROUTE_LOSS_TOL and worst <= ROUTE_GRAD_TOL):
            raise AssertionError("mesh: f32 loss and grad differ")
        out["f32"] = {"loss_err": loss_err, "grad_rel_err": worst}
        del params, want_g, got_g
        gc.collect()
        torch.cuda.empty_cache()

        # mamba2-1.3b prefill through sharded_ssd
        mamba = get_config(MAMBA)
        params = mamba_smoke_params(mamba, 44)
        rng = np.random.default_rng(45)
        pb = {"tokens": torch.from_numpy(rng.integers(
            0, mamba.vocab_size, (PREFILL_B, PREFILL_S))).cuda()}
        res = {}
        for name, ctx in (("unsharded", None), ("mesh", sctx)):
            p = params if ctx is None else P.shard_tree(params, mamba,
                                                        ctx.mesh)
            step = (M.make_prefill_step(mamba) if ctx is None
                    else M.make_prefill_step(mamba, ctx))
            step(p, pb)                                 # warm-up
            torch.cuda.synchronize()
            reset_launches()                            # the main path
            t0 = time.perf_counter()
            logits, _ = step(p, pb)
            logits = M.full(logits).float()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = read_launches()                    # ... ends here
            if counts != expected_launches(mamba):
                raise AssertionError(f"mesh: {MAMBA} {name} prefill "
                                     f"launched {counts}")
            res[name] = (logits, ms)
            del p
        err = float((res["mesh"][0] - res["unsharded"][0]).abs().max())
        log(f"[mesh] {card}: {MAMBA} prefill on a 1x1 DeviceMesh through "
            f"sharded_ssd, bf16 B={PREFILL_B} S={PREFILL_S}: "
            f"{read_launches()['ssd_chunk_kernel']} K2 launches, logits max "
            f"|mesh - unsharded| {err:.3g} (tol {PREFILL_TOL}); step "
            f"{res['mesh'][1]:.3f} ms on the mesh, {res['unsharded'][1]:.3f} "
            "ms unsharded (host clock)")
        if not (err <= PREFILL_TOL and bool(torch.isfinite(
                res["mesh"][0]).all())):
            raise AssertionError(f"mesh: {MAMBA} logits differ by {err}")
        out["mamba_prefill"] = {"logit_err": err,
                                "step_ms": {k: v[1] for k, v in res.items()},
                                "launches": expected_launches(mamba)}
        del params, res
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ------------------------- the pilot world (ranks) ------------------------ #
WORLD_STEPS = 3
INPROC_OUTSIDE_MS = "1.6-8.7"   # the train driver's in-process
                                # train_segment tasks, time outside their
                                # bodies (PERF.md §5; H100 80GB HBM3, 700 W)
WORLD_REL_TOL = 1e-5            # the gloo bodies against one rank, f32
WORLD_TOL = 1e-6                # the rank's losses, last logits and param
                                # changes against the same bodies in this
                                # process: the same code, seed and card
                                # (read bitwise equal, PERF.md)
EXP1_SLOTS, EXP1_TASKS, EXP1_BLOCK = (4, 2), 16, 2
EXP1_COLD_SLOTS = (4,)          # the cold ablations and the compiled runs
                                # on 4 slots alone (the chip script's time)
EXP1_COLD_TASKS = 8             # the cold ablations' tasks: each builds its
                                # groups (and compiles) anew, 0.5-0.8 s a task
                                # (H100 80GB HBM3, 700 W)


def world_no_tf32(mesh):
    """An spmd body: full f32 on this rank, as phase_environment sets it in
    the parent (the ranks are fresh processes)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.cuda.get_device_name(mesh.device)


def world_init(mesh, arch, seed):
    """An spmd body: the params (``smoke_params``) and their AdamW state on
    this rank's card; they stay there as RankRefs."""
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamW, cosine_schedule
    params = smoke_params(get_config(arch), seed)
    return params, AdamW(lr=cosine_schedule(3e-4, 20, 10_000)).init(params)


def world_check(mesh, arch, params, seed):
    """An spmd body: K1 (with lse) and K1b against their plain versions on
    this rank's own inputs of one layer (``check_train_layers`` on the
    first layer of the params the rank holds, whose inputs are the full
    model's); the largest errors by value."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), num_layers=1)
    return check_train_layers(cfg, dict(params, layers=params["layers"][:1]),
                              train_batch(cfg, PREFILL_B, PREFILL_S, seed),
                              f"world rank {mesh.rank}, layer 0")


def world_step(mesh, arch, params, state, seed):
    """An spmd body: one AdamW step on the params and state this rank
    holds, the batch made here from ``seed``; the new params and state stay
    on the rank, the loss, step ms (CUDA events), launches (counted from 0
    around the step, in this rank), the norm of the params' change (the
    step updates them in place: a copy taken before it), AdamW's step
    count and the peak (less that copy) come back by value."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.tree import leaves
    cfg = get_config(arch)
    batch = train_batch(cfg, PREFILL_B, PREFILL_S, seed)
    step = M.make_train_step(cfg, AdamW(lr=cosine_schedule(3e-4, 20, 10_000)))
    before = [p.detach().clone() for p in leaves(params)]
    copy_bytes = sum(t.nbytes for t in before)
    torch.cuda.reset_peak_memory_stats()
    params, state, losses, _, times, counts = timed_steps(step, params, state,
                                                          batch, 1)
    peak = torch.cuda.max_memory_allocated() - copy_bytes
    delta = math.sqrt(float(sum(
        (p.float() - b.float()).square().sum(dtype=torch.float64)
        for p, b in zip(leaves(params), before))))
    return params, state, {"loss": losses[0], "ms": times[0],
                           "launches": counts[0], "delta": delta,
                           "adam_step": int(state.step), "peak": peak}


def world_prefill(mesh, arch, params, seed):
    """An spmd body: a prefill on the rank's params; the last position's
    logits stay on the rank, the launches (counted from 0 around it) come
    back by value."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config(arch)
    tokens = train_batch(cfg, PREFILL_B, PREFILL_S, seed)["tokens"]
    step = M.make_prefill_step(cfg)
    torch.cuda.synchronize()
    reset_launches()                            # the main path starts here
    logits, _ = step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    counts = read_launches()                    # ... and ends here
    return logits[:, -1].clone(), {"launches": counts}


def world_noop(mesh, x):
    """exp1's no-op spmd function: one psum of a scalar on the card."""
    from repro_torch.core import P, psum, shard_map
    return shard_map(lambda a: psum(a, "data"), mesh, P(), P())(
        torch.as_tensor(x, device=mesh.device))


world_noop.__app_kind__ = "spmd"
world_noop.__spmd_jit__ = False         # eager in the rank


def world_noop_jit(mesh, x):
    """The same no-op as exp1 declares it (``spmd_app``'s default jit): the
    rank calls it through ``torch.compile``, ``x`` a 0-d tensor there."""
    from repro_torch.core import P, psum, shard_map
    return shard_map(lambda a: psum(a, "data"), mesh, P(), P())(
        torch.as_tensor(x, device=mesh.device))


world_noop_jit.__app_kind__ = "spmd"


def world_graph_breaks(mesh):
    """An spmd body: ``torch._dynamo.explain`` of exp1's compiled no-op on
    this rank: its graphs, graph breaks and their reasons (does dynamo
    break around the port's collectives?)."""
    import torch._dynamo
    got = torch._dynamo.explain(world_noop_jit)(mesh, 1.0)
    return {"graphs": got.graph_count, "breaks": got.graph_break_count,
            "reasons": [str(r.reason)[:200] for r in got.break_reasons]}


def world_exp1(rpex, cache, jit=False):
    """exp1's workload (benchmarks/exp1_executor.py) on the pilot's world:
    EXP1_TASKS no-op spmd tasks (cold: EXP1_COLD_TASKS) of EXP1_BLOCK
    slots each, on EXP1_SLOTS slots (cold or compiled: EXP1_COLD_SLOTS),
    one repeat; TPT (last end - first
    start) and TS (tasks / TPT) as exp1 defines them.  ``cache`` switches
    the executor's cache, which decides whether the ranks cache the
    block's groups (False: the cold-communicator ablation) and, with
    ``jit``, the compiled body: the graphs dynamo compiled in the rank for
    each task (``graphs``), the ms of each task that compiled any
    (``compile_ms``, its first call) and the median body of the others."""
    from repro_torch.core import ResourceSpec, TaskState, translate
    pilot = rpex.pilot
    pilot.executor.cache_enabled = cache
    out = {}
    n_tasks = EXP1_TASKS if cache else EXP1_COLD_TASKS
    for n in EXP1_SLOTS if cache and not jit else EXP1_COLD_SLOTS:
        if pilot.n_slots > n:
            pilot.shrink(pilot.n_slots - n)
        tasks = [translate(world_noop_jit if jit else world_noop,
                           (float(i),), {}, ResourceSpec(slots=EXP1_BLOCK))
                 for i in range(n_tasks)]
        rpex.tmgr.submit_bulk(tasks)
        if not rpex.tmgr.wait(timeout=600):
            raise AssertionError("world exp1: tasks did not end")
        bad = [t.state for t in tasks if t.state != TaskState.DONE]
        if bad:
            raise AssertionError(f"world exp1: tasks ended {bad[:3]}")
        starts = [t.timestamps.get("SCHEDULED", t.timestamps["TRANSLATED"])
                  for t in tasks]
        ends = [t.timestamps[t.state.value] for t in tasks]
        tpt = max(ends) - min(starts)
        calls = {c["uid"]: c for c in pilot.world.calls}
        groups_ms = [calls[t.uid]["groups_s"] * 1e3 for t in tasks]
        # a task's reply carries the time its rank spent destroying the
        # groups of tasks that ended before it began (cold only)
        reap_ms = [calls[t.uid]["reap_s"] * 1e3 for t in tasks[1:]]
        body_ms = [calls[t.uid]["body_s"] * 1e3 for t in tasks]
        graphs = [calls[t.uid]["graphs"] for t in tasks]
        compiled = [g > 0 for g in graphs]
        out[n] = {"tasks": n_tasks, "tpt_s": tpt, "ts": n_tasks / tpt,
                  "graphs": graphs,
                  "groups_ms": groups_ms, "reap_ms": reap_ms,
                  "compile_ms": [b for b, c in zip(body_ms, compiled) if c],
                  "body_ms": float(np.median([b for b, c in
                                              zip(body_ms, compiled)
                                              if not c] or [0.0]))}
    pilot.grow(max(EXP1_SLOTS) - pilot.n_slots)
    pilot.executor.cache_enabled = True
    return out


def phase_spmd_world(card):
    """The pilot world (``PilotDescription(ranks=N)``) on the card.

    (a) One NCCL rank on cuda:0.  smollm-360m at full width and depth, bf16,
    B=8, S=1024, as a DFK workflow of pilot tasks: an spmd init task leaves
    the params and AdamW state on the rank (RankRefs); a check task holds
    K1 and K1b against their plain versions on the rank's own inputs of one
    layer; WORLD_STEPS train-step tasks take and return the RankRefs; a
    prefill task; a Python task fetches the last position's logits and
    takes their argmax.  Gates: the exact launch counts, counted inside the
    rank (64 K1 and 32 K1b a step, 32 K1 a prefill); the losses, each
    step's param change (its norm, nonzero) and AdamW step count, and
    those logits against the same bodies called in this process from the
    same seed, within WORLD_TOL; no tensor byte sent to the rank, and only
    the logits back.  Each task's time outside its body beside the train
    driver's in-process tasks, each step's time beside the in-process step, the
    rank's peak.
    (b) Two gloo ranks on cuda:0, a (2, 1) block: the spmd bodies of the
    quickstart (psum), colmena (pmean) and IWP (a sharded output: all_gather)
    examples on CUDA tensors against the same bodies at one rank in this
    process, f32, within WORLD_REL_TOL relative.
    (c) exp1's workload on world (a): TPT and TS with the groups cached and
    cold."""
    from repro_torch.configs import get_config
    from repro_torch.core import (DataFlowKernel, PilotDescription,
                                  RPEXExecutor, RankRef, python_app, spmd_app)
    from repro_torch.core.spmd_executor import single_device_mesh
    from repro_torch.examples import (colmena_ensemble, iwp_pipeline,
                                      quickstart)
    from repro_torch.tree import leaves

    arch = "smollm-360m"
    cfg = get_config(arch)
    cuda0 = torch.device("cuda", 0)
    out = {}

    # the same bodies in this process, from the same seeds
    params, state = world_init(None, arch, 50)
    here = []
    for i in range(WORLD_STEPS):
        params, state, m = world_step(None, arch, params, state, 51 + i)
        here.append(m)
    here_logits, here_pre = world_prefill(None, arch, params, 52)
    here_logits = here_logits.float().cpu()
    del params, state
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rpex = RPEXExecutor(PilotDescription(devices=[cuda0], ranks=1,
                                         n_slots=max(EXP1_SLOTS)))
    world = rpex.pilot.world
    start_s = time.perf_counter() - t0
    log(f"[world] {card}: a world of 1 rank ({world.backend}) started in "
        f"{start_s:.2f}s")
    init = spmd_app(slots=1, jit=False)(world_init)
    check = spmd_app(slots=1, jit=False)(world_check)
    step = spmd_app(slots=1, jit=False)(world_step)
    prefill = spmd_app(slots=1, jit=False)(world_prefill)

    @python_app
    def last_argmax(logits):
        return logits.float().argmax(-1).tolist(), logits.float()

    futs = []
    with DataFlowKernel(executors={"rpex": rpex}):
        world.run(world_no_tf32, (), {}, (0,), (1, 1))
        f = init(arch, 50)
        futs.append(f)
        params, state = f.result()
        if not (all(isinstance(r, RankRef) for r in leaves((params, state)))
                and all(r.device == "cuda:0" for r in leaves(
                    (params, state.m, state.v)))):
            raise AssertionError("world: the params and moments are not "
                                 "RankRefs on cuda:0")
        f = check(arch, params, 53)
        futs.append(f)
        layer_err = f.result()
        steps = []
        for i in range(WORLD_STEPS):
            f = step(arch, params, state, 51 + i)
            futs.append(f)
            params, state, m = f.result()
            steps.append(m)
        sent_before_fetch = world.stats["tensor_bytes_to_ranks"]
        back_before_fetch = world.stats["tensor_bytes_from_ranks"]
        f = prefill(arch, params, 52)
        futs.append(f)
        logits_ref, pre = f.result()
        logit_bytes = math.prod(logits_ref.shape) * logits_ref.dtype.itemsize
        argmax, logits = last_argmax(logits_ref).result()
        del params, state, logits_ref
        exp1 = {(cache, jit): world_exp1(rpex, cache, jit)
                for jit in (False, True) for cache in (True, False)}
        breaks = world.run(world_graph_breaks, (), {}, (0,), (1, 1))
    rpex.shutdown()

    want_train = expected_launches(cfg, train=True)
    want_pre = expected_launches(cfg)
    counts = [m["launches"] for m in steps]
    if any(c != want_train for c in counts) or pre["launches"] != want_pre:
        raise AssertionError(f"world: launches {counts} a step and "
                             f"{pre['launches']} a prefill, expected "
                             f"{want_train} and {want_pre}")
    loss_diff = max(abs(a["loss"] - b["loss"]) for a, b in zip(steps, here))
    logit_err = float((logits - here_logits).abs().max())
    delta_rel = max(abs(a["delta"] - b["delta"]) / b["delta"]
                    for a, b in zip(steps, here))
    if not (loss_diff <= WORLD_TOL and logit_err <= WORLD_TOL
            and delta_rel <= WORLD_TOL
            and all(m["delta"] > 0 and np.isfinite(m["loss"]) for m in steps)
            and [m["adam_step"] for m in steps]
            == [m["adam_step"] for m in here]
            == list(range(1, WORLD_STEPS + 1))):
        raise AssertionError(
            f"world: losses {[m['loss'] for m in steps]} against "
            f"{[m['loss'] for m in here]}, param changes "
            f"{[m['delta'] for m in steps]} against "
            f"{[m['delta'] for m in here]}, AdamW steps "
            f"{[m['adam_step'] for m in steps]}, last logits |diff| "
            f"{logit_err} (tol {WORLD_TOL})")
    if sent_before_fetch != 0 or world.stats["tensor_bytes_to_ranks"] != 0:
        raise AssertionError(f"world: {world.stats['tensor_bytes_to_ranks']}"
                             " tensor bytes crossed to the rank")
    if (back_before_fetch != 0 or world.stats["tensor_bytes_from_ranks"]
            != logit_bytes):
        raise AssertionError(f"world: {world.stats['tensor_bytes_from_ranks']}"
                             f" tensor bytes came back, expected the logits' "
                             f"{logit_bytes}")
    agree = float(np.mean(np.array(argmax) == here_logits.argmax(-1).numpy()))
    calls = {c["uid"]: c for c in world.calls}
    tasks = []
    for name, f in zip(["init", "check"]
                       + [f"step {i}" for i in range(WORLD_STEPS)]
                       + ["prefill"], futs):
        ts = f.task.timestamps
        task_s = ts["DONE"] - min(ts.values())
        c = calls[f.task.uid]
        tasks.append({"name": name, "task_ms": task_s * 1e3,
                      "body_ms": c["body_s"] * 1e3,
                      "outside_ms": (task_s - c["body_s"]) * 1e3,
                      "groups_ms": c["groups_s"] * 1e3})
    log(f"[world] {card}: {arch} at full width and depth on a 1-rank NCCL "
        f"world, bf16 B={PREFILL_B} S={PREFILL_S}: losses "
        f"{[m['loss'] for m in steps]} against in-process "
        f"{[m['loss'] for m in here]} (|diff| {loss_diff:.3g}, tol "
        f"{WORLD_TOL}); param change norms {[m['delta'] for m in steps]} "
        f"against {[m['delta'] for m in here]} (rel |diff| {delta_rel:.3g})"
        f"; last-position logits max |diff| {logit_err:.3g}, "
        f"argmax agreement {agree:.3f}; launches a step {counts[0]}, a "
        f"prefill {pre['launches']}; K1 with lse vs plain on the rank's own "
        f"inputs max |diff| {layer_err['fwd']:.4g}, K1b {layer_err['bwd']:.4g}"
        f"; tensor bytes to the rank {world.stats['tensor_bytes_to_ranks']}, "
        f"back {world.stats['tensor_bytes_from_ranks']} (the logits)")
    for m, h in zip(steps, here):
        log(f"[world] {card}: train step on the rank {m['ms']:.3f} ms, in "
            f"process {h['ms']:.3f} ms; the rank's peak "
            f"{m['peak'] / 2**30:.3f} GiB")
    for t in tasks:
        log(f"[world] {card}: task {t['name']}: {t['task_ms']:.3f} ms, body "
            f"{t['body_ms']:.3f} ms, outside its body {t['outside_ms']:.3f} "
            f"ms (group creation {t['groups_ms']:.3f} ms; the train driver's "
            f"in-process tasks {INPROC_OUTSIDE_MS} ms outside their bodies)")
    for (cache, jit), runs in exp1.items():
        for n, r in runs.items():
            log(f"[world] {card}: exp1 {r['tasks']} no-op psum tasks of "
                f"{EXP1_BLOCK} slots on {n} slots, "
                f"{'compiled (jit)' if jit else 'eager'}, groups "
                f"{'cached' if cache else 'cold'}: TPT {r['tpt_s'] * 1e3:.3f}"
                f" ms, TS {r['ts']:.1f} tasks/s; group creation in the rank "
                f"median {float(np.median(r['groups_ms'])):.3f} ms, first "
                f"task {r['groups_ms'][0]:.3f}, last {r['groups_ms'][-1]:.3f}"
                f"; their destruction median "
                f"{float(np.median(r['reap_ms'])):.3f} ms, total "
                f"{sum(r['reap_ms']):.3f}"
                + (f"; tasks that compiled in the rank "
                   f"{len(r['compile_ms'])} (dynamo graphs each task "
                   f"{r['graphs']}), each such task's first call "
                   + ", ".join(f"{c:.1f}" for c in r["compile_ms"])
                   + f" ms, the other bodies median {r['body_ms']:.3f} ms"
                   if jit else ""))
        graphs = [g for r in runs.values() for g in r["graphs"]]
        if jit and cache and not (graphs[0] > 0 and not any(graphs[1:])):
            # one key: the no-op on the world's one rank, whatever the slots
            # and values; dynamo compiling again is a recompile
            raise AssertionError(f"world exp1 jit: dynamo graphs compiled in "
                                 f"the rank each task {graphs}, expected "
                                 "some for the first task and none after")
        if jit and not cache and not all(graphs):
            raise AssertionError(f"world exp1 jit, cold: dynamo graphs each "
                                 f"task {graphs}, expected some in every "
                                 "task")
    log(f"[world] {card}: torch._dynamo.explain of the compiled no-op (a "
        f"psum through core/collectives.py) on the NCCL rank: "
        f"{breaks['graphs']} graph(s), {breaks['breaks']} graph break(s) "
        f"{breaks['reasons']}")
    out["a"] = {"start_s": start_s, "losses": [m["loss"] for m in steps],
                "in_process_losses": [m["loss"] for m in here],
                "loss_diff": loss_diff, "logit_err": logit_err,
                "deltas": [m["delta"] for m in steps],
                "in_process_deltas": [m["delta"] for m in here],
                "step_ms": [m["ms"] for m in steps],
                "in_process_step_ms": [m["ms"] for m in here],
                "peak_bytes": max(m["peak"] for m in steps),
                "launches": {"train_step": counts[0],
                             "prefill": pre["launches"]},
                "layer_err": layer_err, "tasks": tasks, "exp1": exp1,
                "graph_breaks": breaks}

    # (b) two gloo ranks on one card
    rpex2 = RPEXExecutor(PilotDescription(devices=[cuda0], ranks=2,
                                          n_slots=4))
    world2 = rpex2.pilot.world
    one = single_device_mesh(cuda0)
    decks = [colmena_ensemble.pre_process.__wrapped_app__(x)
             for x in (0.3, 1.7)]
    payloads = [iwp_pipeline.load_and_tile.__wrapped_app__(i)
                for i in range(2)]
    with DataFlowKernel(executors={"rpex": rpex2}):
        world2.run(world_no_tf32, (), {}, (0, 1), (2, 1))
        norm = quickstart.parallel_norm({"scale": 2.0}, 16).result()
        sims = [f.result() for f in [colmena_ensemble.simulate(d)
                                     for d in decks]]
        scores = [f.result() for f in [iwp_pipeline.infer(p)
                                       for p in payloads]]
        got = {"quickstart": [norm.fetch().double()],
               "colmena": [torch.tensor(s["y"], dtype=torch.float64)
                           for s in sims],
               "iwp": [s["scores"].fetch().double() for s in scores]}
        where = {norm.device, *(s["scores"].device for s in scores)}
    rpex2.shutdown()
    want = {"quickstart": [quickstart.parallel_norm.__wrapped_app__(
                one, {"scale": 2.0}, 16).cpu().double()],
            "colmena": [torch.tensor(colmena_ensemble.simulate.__wrapped_app__(
                one, d)["y"], dtype=torch.float64) for d in decks],
            "iwp": [iwp_pipeline.infer.__wrapped_app__(one, p)["scores"]
                    .cpu().double() for p in payloads]}
    rel = {k: max(float(((g - w).abs() / w.abs().clamp_min(1e-30)).max())
                  for g, w in zip(got[k], want[k])) for k in got}
    log(f"[world] {card}: 2 gloo ranks on cuda:0 ({world2.backend}), a (2, 1) "
        f"block, results on {sorted(where)}: quickstart psum (all_reduce), "
        f"colmena pmean (all_reduce), IWP scores gathered (all_gather) on "
        f"CUDA tensors; relative error against one rank in process: "
        + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
        + f" (tol {WORLD_REL_TOL})")
    if where != {"cuda:0"} or not all(v <= WORLD_REL_TOL for v in rel.values()):
        raise AssertionError(f"world: gloo bodies on cuda {rel} on {where}")
    out["b"] = {"rel_err": rel, "backend": world2.backend}
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------- the train driver on a world ---------------------- #
WORLD_TRAIN_SHARDS = ["--data-shards", "2"]  # two gloo ranks on the card
# smollm-360m at full width cut to the in-process driver's DRIVER_LAYERS
# on the world, so that the two runs' losses compare: two gloo ranks
# sharing the card took 6.5-10.2 s a full-depth step, 209.8 s of the chip
# script's 699.8 (H100 80GB HBM3, 700 W)
WORLD_TRAIN_LAYERS = ["--layers", str(DRIVER_LAYERS)]
WORLD_TRAIN_TOL = 5e-3          # the world's losses against the in-process
                                # driver's: bf16, two summation orders
                                # (tests/test_torch_train_world.py)
# the reduced world's state against the in-process driver's at steps 2 and
# 4 (train.state_drift: each param over its change from init, each AdamW
# moment over itself, the worst leaf), bf16, --data-shards 2: they read
# 0.037, 0.0045 and 0.0092 on the card (tools/train_state_drift.py) and
# 0.072, 0.0038 and 0.0069 on the CPU, while a segment that drops its last
# update reads 0.52 on the params and ranks that all take the first rows
# 0.8 to 1.2 on all three (CPU).  At full width the reference's init is
# chaotic: the in-process driver with 2 microbatches lies 1.05 (m, whole
# tree) from itself with 1 after one step, so the state is held there at
# the reduced config
WORLD_STATE_TOL = {"params": 0.25, "m": 0.05, "v": 0.05}
# the drill kills a rank of the first segment (it reaches half the run),
# before any checkpoint: the state is rebuilt from the seed, 2 steps again
WORLD_DRILL_ARGV = ["--reduced", "--steps", "4", "--segment", "2", "--batch",
                    "4", "--seq", "64", "--ckpt-every", "2", "--eval-every",
                    "4"]


def phase_train_world(card, inproc):
    """A main path: ``repro_torch.launch.train.main`` with
    WORLD_TRAIN_SHARDS (``--data-shards 2``: the params sharded over the
    data axis, ZeRO-3), on smollm-360m at full width cut to
    WORLD_TRAIN_LAYERS, bf16, B=8 S=1024: the driver starts a pilot world
    of 2 gloo ranks sharing the card, builds the state in the ranks and
    runs every task there.  4 steps in 2 segments with checkpoints and one
    evaluation, then a restart to step 6 from the checkpoint.  Gates: K1
    twice and K1b once a layer and step counted inside each rank's segment
    bodies; the losses against the in-process driver's at the same cut
    (``inproc``, phase_train_driver) within WORLD_TRAIN_TOL; no
    tensor byte across the world's boundary either way; each rank's peak
    flat from segment to segment.  The world checkpoints at steps 4 and 6
    alone (``--ckpt-every 4``).  Reported: the world's start, each
    segment's step time in each rank beside the in-process step, each
    task's time outside its body.  Then the fault drill at the reduced
    config: a rank of the first segment killed, the world restarted, the
    state rebuilt from the seed (no checkpoint yet; the restart above reads
    one on a new world), and the losses equal to an undisturbed run's; the
    undisturbed run's params and AdamW moments at steps 2 and 4 against
    the in-process driver's at the same config within WORLD_STATE_TOL (a
    dropped update, ranks given the wrong rows or a wrong gradient
    reduction show there; the losses hardly see them)."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.launch import train
    L = int(WORLD_TRAIN_LAYERS[1])
    ckpt = ROOT / "build" / "chip_smoke_ckpt_world"
    shutil.rmtree(ckpt, ignore_errors=True)
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd": L,
            "ssd_chunk_kernel": 0, "ssd_chunk_bwd_kernel": 0,
            "ssd_pass_kernel": 0, "ssd_pass_bwd_kernel": 0}
    runs = []
    try:
        for name, steps, segments in (("run", 4, 2), ("restart", 6, 1)):
            gc.collect()
            torch.cuda.empty_cache()
            rec = {}
            t0 = time.perf_counter()
            losses = train.main(TRAIN_ARGV + WORLD_TRAIN_LAYERS
                                + WORLD_TRAIN_SHARDS + [
                "--steps", str(steps), "--ckpt-dir", str(ckpt),
                "--ckpt-every", "4"], rec)
            seconds = time.perf_counter() - t0
            if len(losses) != segments:
                raise AssertionError(f"train world ({name}): {len(losses)} "
                                     f"segments, expected {segments}")
            ranks = [s["attempts"][0]["ranks"] for s in rec["segments"]]
            per_step = [[{k: v // 2 for k, v in r["launches"].items()}
                         for r in seg] for seg in ranks]
            if any(c != want for seg in per_step for c in seg):
                raise AssertionError(f"train world ({name}): launches a step "
                                     f"in each rank {per_step}, expected "
                                     f"{want}")
            stats = rec["world_stats"]
            if stats["tensor_bytes_to_ranks"] or \
                    stats["tensor_bytes_from_ranks"]:
                raise AssertionError(f"train world ({name}): tensor bytes "
                                     f"crossed: {stats}")
            peaks = list(zip(*[s["peak_bytes"] for s in rec["segments"]]))
            if any(max(p) > p[0] + 2**28 for p in peaks):
                raise AssertionError(f"train world ({name}): a rank's peak "
                                     f"grew from segment to segment: {peaks}")
            start = [e["seconds"] for e in rec["events"]
                     if e["event"] == "WORLD_START"]
            calls = rec["world_calls"]
            outside = [(c["call_s"] - c["body_s"]) * 1e3 for c in calls]
            step_ms = [[r["seconds"] / 2 * 1e3 for r in seg] for seg in ranks]
            log(f"[train-world] {card}: driver ({name}) to step {steps} on 2 "
                f"gloo ranks sharing the card ({' '.join(WORLD_TRAIN_SHARDS)}"
                f", {L} layers): losses {losses}, world start {start[0]:.2f}s, "
                f"{seconds:.1f}s in all; launches a step in each rank "
                f"{per_step[0]}; a step in each rank (segment body / 2) "
                + "; ".join(", ".join(f"{m:.1f}" for m in seg)
                            for seg in step_ms)
                + " ms; each rank's peak after each segment "
                + "; ".join(", ".join(f"{b / 2**30:.3f}" for b in p)
                            for p in peaks)
                + f" GiB; tensor bytes to the ranks "
                f"{stats['tensor_bytes_to_ranks']}, back "
                f"{stats['tensor_bytes_from_ranks']}; time outside each "
                f"task's body (init, segments, checkpoints, evaluation) "
                + ", ".join(f"{m:.1f}" for m in outside) + " ms")
            runs.append({"name": name, "losses": losses, "seconds": seconds,
                         "start_s": start[0], "per_step": per_step[0][0],
                         "step_ms": step_ms, "peaks": peaks,
                         "outside_ms": outside})
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    losses = runs[0]["losses"] + runs[1]["losses"]
    diff = [abs(a - b) for a, b in zip(losses, inproc["losses"])]
    log(f"[train-world] {card}: losses on the world {losses}, in process at "
        f"the same cut {inproc['losses']}: |diff| per segment "
        + ", ".join(f"{d:.2e}" for d in diff) + f" (tol {WORLD_TRAIN_TOL})")
    if len(diff) != len(inproc["losses"]) or max(diff) > WORLD_TRAIN_TOL:
        raise AssertionError(f"train world: losses {losses} against "
                             f"{inproc['losses']}")

    drill, drift = {}, {}
    t0 = time.perf_counter()
    cks = {name: ROOT / "build" / f"chip_smoke_ckpt_world_{name}"
           for name in ("inproc", "clean", "drill")}
    try:
        for ck in cks.values():
            shutil.rmtree(ck, ignore_errors=True)
        plain = train.main(WORLD_DRILL_ARGV + ["--ckpt-dir",
                                               str(cks["inproc"])])
        for name in ("clean", "drill"):
            rec = {}
            drill[name] = train.main(
                WORLD_DRILL_ARGV + WORLD_TRAIN_SHARDS
                + ["--ckpt-dir", str(cks[name])]
                + (["--inject-failure", "1"] if name == "drill" else []), rec)
            restarts = [e for e in rec["events"]
                        if e["event"] == "WORLD_RESTART"]
            drill[f"{name}_restarts"] = len(restarts)
            drill[f"{name}_recomputed"] = rec["recomputed"]
            drill[f"{name}_rebuilt_at"] = rec["rebuilt_at"]
        drift = {step: train.state_drift(
            reduce_config(get_config("smollm-360m")), cks["clean"],
            cks["inproc"], step, "cuda") for step in (2, 4)}
    finally:
        for ck in cks.values():
            shutil.rmtree(ck, ignore_errors=True)
    drill["seconds"] = time.perf_counter() - t0
    log(f"[train-world] {card}: fault drill at the reduced config "
        f"({drill['seconds']:.1f}s with the in-process and undisturbed runs "
        f"and the state reads), a rank "
        f"of the segment to step 2 killed: losses {drill['drill']}, the "
        f"state rebuilt at step {drill['drill_rebuilt_at']} after "
        f"{drill['drill_restarts']} world restart, "
        f"{drill['drill_recomputed']} steps recomputed; undisturbed "
        f"{drill['clean']}")
    if not (drill["drill"] == drill["clean"]
            and drill["drill_restarts"] == 1 and drill["clean_restarts"] == 0
            and drill["drill_rebuilt_at"] == [0]
            and drill["drill_recomputed"] == 2):
        raise AssertionError(f"train world drill: {drill}")
    for step, d in drift.items():
        log(f"[train-world] {card}: the reduced world's state at step {step} "
            f"against the in-process driver's (losses {drill['clean']} and "
            f"{plain}; params over their change from init, moments over "
            f"themselves): "
            + ", ".join(f"{k} worst leaf {d[k]['worst'][0]:.4g} (leaf "
                        f"{d[k]['worst'][1]}), whole tree {d[k]['all']:.4g}"
                        for k in ("params", "m", "v"))
            + f"; AdamW steps {d['steps']} (tol on the worst leaf "
            f"{WORLD_STATE_TOL})")
        if d["steps"] != (step, step) or any(
                d[k]["worst"][0] > tol for k, tol in WORLD_STATE_TOL.items()):
            raise AssertionError(f"train world: the reduced state at step "
                                 f"{step}: " + str({k: d[k]["worst"] for k in
                                                    WORLD_STATE_TOL}))
    gc.collect()
    torch.cuda.empty_cache()
    return {"runs": runs, "losses": losses, "loss_diff": max(diff),
            "per_step": runs[0]["per_step"], "drill": drill,
            "state_drift": {s: {k: d[k]["worst"][0] for k in WORLD_STATE_TOL}
                            for s, d in drift.items()}}


def count_step(step, args):
    """``step(*args)`` on the card under a ``StepCounter``, launches
    counted from 0: (its totals, launches, the allocator's peak over the
    step with the memory held outside the step's arguments taken out)."""
    from repro_torch.roofline.counter import StepCounter
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                            # the main path starts here
    with StepCounter(args) as c:
        step(*args)
        torch.cuda.synchronize()
    launches = read_launches()                  # ... and ends here
    peak = torch.cuda.max_memory_allocated() - before + c.arg_bytes
    return c.totals(), launches, peak


DRYRUN_CELLS = (("smollm-360m", "train_4k"), (GEMMA, "prefill_32k"))
DRYRUN_DIR = ROOT / "build" / "dryrun_chip"
DRYRUN_TIMEOUT_S = 600


def start_dryruns():
    """The dry-run CLI (``python -m repro_torch.launch.dryrun``) on each of
    DRYRUN_CELLS, one subprocess each on the host's CPU with no card
    visible, started at once: they run beside the card's phases, at a
    lower priority and on two threads each, and ``phase_cost`` waits for
    them.  {cell: (process, start (wall clock), stderr path)}."""
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    DRYRUN_DIR.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    out = {}
    for arch, shape in DRYRUN_CELLS:
        err = DRYRUN_DIR / f"{arch}__{shape}.err"
        with open(err, "w") as f:
            out[arch, shape] = (subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--out", str(DRYRUN_DIR)], env=env,
                cwd=str(ROOT), stdout=subprocess.DEVNULL, stderr=f,
                preexec_fn=lambda: os.nice(10)), time.time(), err)
    return out


def phase_cost(card, step_ms, dryruns):
    """Cost accounting (``repro_torch.roofline``) against the card.

    (a) smollm-360m's train step (bf16, B=8, S=1024, full depth, AdamW),
    gemma2-9b's prefill (B=1, S=8192, 42 layers, K1 at D=256) and
    mamba2-1.3b's train step (K2 and K2b), each as the phases above run
    it, counted twice: on ``meta`` tensors of the same shapes and dtypes
    (the kernels' meta routes) and on the card with the kernels launched.
    FLOPs, bytes and the kernels' costs must be equal exactly, and the
    meta count's peak within 10% of the allocator's peak over the card's
    step (its arguments counted, what the card held besides them taken
    out).  ``step_ms`` holds each step's time as its phase measured it:
    the step's share of the bf16 peak is model FLOPs / (step time x
    989e12).  (b) The dry-run CLI (``python -m
    repro_torch.launch.dryrun``) in subprocesses on the host's CPU (no
    card visible; ``dryruns``, started by ``start_dryruns`` at the
    script's start) on the fake 16 x 16 world: smollm-360m train_4k (the
    model-sharded train step) and gemma2-9b prefill_32k at full width and
    depth, each artifact ``ok``."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamState, AdamW, cosine_schedule
    from repro_torch.roofline.analysis import (collective_census,
                                               roofline_terms,
                                               step_share_of_peak)
    from repro_torch.roofline.counter import StepCounter
    from repro_torch.tree import tree_map
    meta = lambda t: torch.empty_like(t, device="meta")
    res = {}
    for name, arch, kind, B, S in (
            ("smollm-360m train", "smollm-360m", "train", PREFILL_B,
             PREFILL_S),
            (f"{GEMMA} prefill", GEMMA, "prefill", GEMMA_B, GEMMA_S),
            (f"{MAMBA} train", MAMBA, "train", PREFILL_B, PREFILL_S)):
        cfg = get_config(arch)
        gc.collect()
        torch.cuda.empty_cache()
        params = (mamba_smoke_params(cfg, 71) if arch == MAMBA
                  else smoke_params(cfg, 72))
        batch = train_batch(cfg, B, S, 73)
        if kind == "train":
            opt = AdamW(lr=cosine_schedule(3e-4, 20, 10_000))
            state = opt.init(params)
            step = M.make_train_step(cfg, opt)
            args = (params, state, batch)
            meta_args = (tree_map(meta, params),
                         AdamState(state.step.clone(), tree_map(meta, state.m),
                                   tree_map(meta, state.v)),
                         tree_map(meta, batch))
        else:
            step = M.make_prefill_step(cfg)
            args = (params, {"tokens": batch["tokens"]})
            meta_args = tuple(tree_map(meta, a) for a in args)
        t0 = time.perf_counter()
        with StepCounter(meta_args) as cm:
            step(*meta_args)
        on_meta = cm.totals()
        meta_s = time.perf_counter() - t0
        on_card, launches, card_peak = count_step(step, args)
        del params, batch, args
        if kind == "train":
            del state
        mf = cfg.model_flops_per_token(kind == "train") * B * S
        art = {"cost": {"flops_per_device": on_card["flops"],
                        "bytes_per_device": on_card["bytes"]},
               "collectives": collective_census([]), "n_chips": 1,
               "model_flops_global": mf}
        roof = roofline_terms(art)
        share = step_share_of_peak(mf, step_ms[name] / 1e3)
        kernels = {k: v["calls"] for k, v in on_card["kernels"].items()}
        log(f"[cost] {name} (B={B}, S={S}, {cfg.num_layers} layers, "
            f"{cfg.dtype}): counted {on_card['flops'] / 1e12:.4f} TFLOP and "
            f"{on_card['bytes'] / 1e9:.4f} GB on the card, "
            f"{on_meta['flops'] / 1e12:.4f} TFLOP and "
            f"{on_meta['bytes'] / 1e9:.4f} GB on meta ({meta_s:.1f}s); "
            f"kernels {kernels}, launches {launches}; peak on meta "
            f"{on_meta['peak_bytes'] / 2**30:.3f} GiB, counted on the card "
            f"{on_card['peak_bytes'] / 2**30:.3f} GiB, the allocator's "
            f"{card_peak / 2**30:.3f} GiB; model FLOPs "
            f"{mf / 1e12:.4f} T, over counted "
            f"{roof['model_flops_over_counted_flops']:.4f}; step "
            f"{step_ms[name]:.3f} ms, {100 * share:.2f}% of the bf16 peak; "
            f"roofline bound {1e3 * max(roof['compute_s'], roof['memory_s']):.3f}"
            f" ms ({roof['dominant']}), fraction "
            f"{roof['roofline_fraction']:.4f} ({card})")
        diff = {k: (on_card["by_name"].get(k), on_meta["by_name"].get(k))
                for k in set(on_card["by_name"]) | set(on_meta["by_name"])
                if on_card["by_name"].get(k) != on_meta["by_name"].get(k)}
        if any(on_card[k] != on_meta[k] for k in ("flops", "bytes",
                                                   "kernels")) or diff:
            raise AssertionError(f"cost {name}: meta and card counts differ: "
                                 f"bytes by name (card, meta) {diff}")
        if any(launches[k] != v for k, v in kernels.items()) or \
                sum(launches.values()) != sum(kernels.values()):
            raise AssertionError(f"cost {name}: kernel calls counted "
                                 f"{kernels}, launched {launches}")
        if abs(on_meta["peak_bytes"] - card_peak) > 0.10 * card_peak:
            raise AssertionError(f"cost {name}: meta peak "
                                 f"{on_meta['peak_bytes']} vs the card's "
                                 f"{card_peak}")
        res[name] = {"flops": on_card["flops"], "bytes": on_card["bytes"],
                     "kernels": on_card["kernels"], "meta_peak":
                     on_meta["peak_bytes"], "card_peak": card_peak,
                     "model_flops": mf, "share_of_peak": share,
                     "roofline": roof}
    gc.collect()
    torch.cuda.empty_cache()

    for (arch, shape), (proc, t0, err_path) in dryruns.items():
        try:
            rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise AssertionError(f"dryrun {arch} {shape}: over "
                                 f"{DRYRUN_TIMEOUT_S}s")
        path = DRYRUN_DIR / "pod16x16" / f"{arch}__{shape}.json"
        # its own time: from its start to its artifact's last write
        seconds = path.stat().st_mtime - t0 if path.exists() else float("nan")
        a = json.loads(path.read_text()) if path.exists() else {}
        if rc or a.get("status") != "ok":
            raise AssertionError(f"dryrun {arch} {shape}: rc {rc}, "
                                 f"{a.get('status')}: "
                                 f"{err_path.read_text()[-3000:]}")
        roof = a["roofline"]
        log(f"[cost] dryrun pod16x16 {arch} {shape} on the host's CPU: ok in "
            f"{seconds:.1f}s, beside the card's phases ({a['num_layers']} layers, "
            f"microbatches {a['microbatches']}): per rank "
            f"{a['cost']['flops_per_device'] / 1e12:.3f} TFLOP, "
            f"{a['cost']['bytes_per_device'] / 1e9:.3f} GB, collectives "
            f"{a['collectives']['moved_bytes_per_device'] / 1e9:.3f} GB, "
            f"peak {a['peak_bytes_per_device'] / 1e9:.2f} GB; terms compute "
            f"{roof['compute_s']:.4f} s, memory {roof['memory_s']:.4f} s, "
            f"collective {roof['collective_s']:.4f} s ({roof['dominant']})")
        res[f"dryrun {arch} {shape}"] = roof
    return res


def main():
    t_start = time.perf_counter()
    card = phase_environment()
    dryruns = start_dryruns()
    try:
        run_phases(t_start, card, dryruns)
    finally:
        for proc, _, _ in dryruns.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run_phases(t_start, card, dryruns):
    sass = phase_build()
    from repro_torch.configs import get_config
    from repro_torch.kernels.ref import ssd_pass_plain
    from repro_torch.kernels.ssd import ssd_chunk_plain
    from repro_torch.models import transformer as T
    err = phase_kernel_vs_plain()
    ssd_err = phase_ssd_vs_plain()
    ssd_bwd_err = phase_ssd_bwd_vs_plain()
    pass_err = phase_ssd_pass_vs_plain()
    lse_err = phase_lse_vs_plain()
    bwd_err = phase_bwd_vs_plain()
    phase_no_key_rows()
    d256_err = phase_d256()
    seq_err, seq = phase_seq_shards(card)

    smollm = get_config("smollm-360m")
    flash = FLASH_ROUTE
    ssd = ("ssd_chunk", ssd_chunk_plain, check_ssd_terms,
           f"{SSD_TOL} abs + rel")
    prefill = phase_prefill(smollm, smoke_params(smollm, 0), [flash], seed=2)
    smollm32 = dataclasses.replace(smollm, dtype="float32")
    phase_prefill_vs_decode(smollm32, smoke_params(smollm32, 1), B=2, S=32,
                            seed=3)
    serve_tok_s = phase_serve("smollm-360m")

    mamba = get_config("mamba2-1.3b")
    ssd_pass = ("ssd_pass", ssd_pass_plain, check_pass_terms,
                f"y {TOL[torch.bfloat16]} abs + rel and normwise "
                f"{FWD_NORM_TOL[torch.bfloat16]}, the states {SSD_TOL} and "
                f"{SSD_BWD_NORM_TOL}")
    mamba_prefill = phase_prefill(mamba, mamba_smoke_params(mamba, 7),
                                  [ssd, ssd_pass], seed=5)
    mamba32 = dataclasses.replace(mamba, dtype="float32",
                                  num_layers=MAMBA_DECODE_LAYERS)
    # two chunks of 256: crosses the recurrence between chunks
    phase_prefill_vs_decode(mamba32, T.init_params(mamba32, 1, device="cuda"),
                            B=2, S=512, seed=6)
    mamba_serve_tok_s = phase_serve("mamba2-1.3b")

    phase_train_routes()
    train = phase_train_driver()
    mamba_route = phase_mamba_train_route()
    mamba_train = phase_mamba_train(card)
    moe = phase_moe(flash, ssd, ssd_pass)
    jamba_route = phase_jamba_train_route()
    qwen_train = phase_qwen_train(card)
    gemma = phase_gemma(card, flash)
    vlm = phase_vlm(card, flash)
    dense = phase_dense_archs(card, flash)
    mesh = phase_mesh(card)
    world = phase_spmd_world(card)
    train_world = phase_train_world(card, train)

    t = phase_timings(card)
    # K1 at the MoE paths' attention: qwen3-moe's 16 q heads a kv head,
    # dbrx's head dim 128
    t_moe = {arch: phase_timings(card, (PREFILL_B, PREFILL_S, c.num_heads,
                                        c.num_kv_heads, c.head_dim))
             for arch, c in ((a, get_config(a)) for a in (QWEN, DBRX))}
    t2 = phase_ssd_timings(card)
    t3 = phase_train_timings(card)
    t4 = phase_d256_timings(card)
    t5 = phase_ssd_bwd_timings(card)
    t7 = phase_ssd_pass_timings(card)
    t6 = phase_arch_timings(card)
    phase_cost(card, {"smollm-360m train": t3["step_ms"],
                      f"{GEMMA} prefill": gemma["prefill"]["step_ms"],
                      f"{MAMBA} train": mamba_train["step_ms"]}, dryruns)
    for arch, pre, tok_s in (("smollm-360m", prefill, serve_tok_s),
                             ("mamba2-1.3b", mamba_prefill, mamba_serve_tok_s),
                             *((f"{a} ({moe[a]['layers']} layers)", moe[a],
                                moe[a]["serve_tok_s"]) for a in moe)):
        log(f"[timing] {card}: {arch} prefill step {pre['step_ms']:.3f} ms "
            f"(B={PREFILL_B}, S={PREFILL_S}), serve "
            + (f"{tok_s:.1f} generated tok/s" if tok_s else "not run")
            + f", peak memory in prefill {pre['peak_bytes'] / 2**30:.3f} GiB")
    log(f"[timing] {card}: smollm-360m train step {t3['step_ms']:.3f} ms "
        f"(B={PREFILL_B}, S={PREFILL_S}, bf16), {t3['tok_s']:.0f} tokens/s, "
        f"peak {t3['peak_bytes'] / 2**30:.3f} GiB; driver launches per step "
        f"{train['per_step']}, peak {train['peak_bytes'] / 2**30:.3f} GiB")
    for arch, tr in ((MAMBA, mamba_train), (f"{QWEN} ({QWEN_TRAIN_LAYERS} "
                                             "layer)", qwen_train)):
        log(f"[timing] {card}: {arch} train step {tr['step_ms']:.3f} ms "
            f"(B={PREFILL_B}, S={PREFILL_S}, bf16, remat full, AdamW), "
            f"{PREFILL_B * PREFILL_S / (tr['step_ms'] / 1e3):.0f} tokens/s, "
            f"peak {tr['peak_bytes'] / 2**30:.3f} GiB")
    arch_prefill = {GEMMA: gemma["prefill"],
                    f"{VLM} ({VLM_LAYERS} layers)": vlm["prefill"],
                    **{a: dense[a] for a in DENSE}}
    arch_train = {f"{GEMMA} ({GEMMA_TRAIN_LAYERS} layers)": gemma["train"],
                  f"{VLM} ({VLM_TRAIN_LAYERS} layer)": vlm["train"],
                  **{a: dense[a]["train"] for a in DENSE}}
    for arch, pre in arch_prefill.items():
        log(f"[timing] {card}: {arch} prefill step {pre['step_ms']:.3f} ms "
            f"(bf16), serve "
            + (f"{pre['serve_tok_s']:.1f} generated tok/s"
               if pre.get("serve_tok_s") else "not run")
            + f", peak memory in prefill {pre['peak_bytes'] / 2**30:.3f} GiB")
    for arch, tr in arch_train.items():
        log(f"[timing] {card}: {arch} train step {tr['step_ms']:.3f} ms "
            f"(bf16, remat full, AdamW), {tr['tok_s']:.0f} tokens/s, peak "
            f"{tr['peak_bytes'] / 2**30:.3f} GiB")
    log(f"[train] route comparisons, worst grad leaf relative to its largest "
        f"magnitude: {MAMBA} {mamba_route['grad_rel_err']:.3g}, {JAMBA} "
        f"{jamba_route['grad_rel_err']:.3g} (tol {ROUTE_GRAD_TOL})")
    world_steps = [m for seg in train_world["runs"][0]["step_ms"] for m in seg]
    log(f"[timing] {card}: smollm-360m train step on 2 gloo ranks sharing "
        f"the card ({' '.join(WORLD_TRAIN_SHARDS)}, the train driver on a "
        f"world): " + ", ".join(f"{m:.1f}" for m in world_steps)
        + f" ms in each rank's segment bodies, beside {t3['step_ms']:.3f} ms "
        "in process (phase_train_timings)")
    for r in train["runs"]:
        for task in r["tasks"]:
            log(f"[timing] {card}: driver ({r['name']}) train_segment "
                f"{task['uid']}: task {task['task_s'] * 1e3:.3f} ms, body "
                f"{task['body_s'] * 1e3:.3f} ms ({task['steps']} steps), "
                f"outside its body {task['outside_s'] * 1e3:.3f} ms; the "
                f"same {sum(task['steps'])} steps called directly "
                f"{sum(task['steps']) * t3['step_ms']:.3f} ms "
                f"({t3['step_ms']:.3f} ms a step, phase_train_timings)")
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:114",
        "launches": prefill["launches"]["flash_attention_fwd"],
        "max_abs_err": max(err, prefill["layer_err"]["flash_attention"],
                           lse_err, d256_err["fwd"], seq_err,
                           *(m["layer_err"]["flash_attention"]
                             for m in (*moe.values(),
                                       *arch_prefill.values())),
                           *(t["layer_err"]["fwd"] for t in arch_train.values())),
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"], "d256": t4["fwd"],
        "d256_cap0": t4["fwd_cap0"],
        "wgmma_kernels": sass["flash_attention_fwd"]["wgmma"],
        "moe_launches": {a: m["launches"]["flash_attention_fwd"]
                         for a, m in moe.items()},
        "moe_shapes": t_moe,
        "arch_launches": {a: p["launches"]["flash_attention_fwd"]
                          for a, p in arch_prefill.items()},
        "arch_train_launches": {a: t["per_step"]["flash_attention_fwd"]
                                for a, t in arch_train.items()},
        "arch_shapes": {a: t["fwd"] for a, t in t6.items()},
        "seq_shards": {k: {"unsharded_ms": x["unsharded_fwd_ms"],
                           "rank_ms": [r["fwd_ms"] for r in x["ranks"]],
                           "last_rank_library_ms": x["ranks"][-1]["sdpa"][
                               "fwd"][1],
                           "last_rank_plain_ms": x["ranks"][-1]["plain_ms"][
                               "fwd"]}
                       for k, x in seq.items()},
        "mesh_launches": mesh["train"]["launches"]["flash_attention_fwd"],
        "world_launches": {k: v["flash_attention_fwd"] for k, v in
                           world["a"]["launches"].items()},
        "world_train_launches": train_world["per_step"][
            "flash_attention_fwd"]}, {
        "name": "ssd_chunk_kernel", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd.py:74",
        "launches": mamba_prefill["launches"]["ssd_chunk_kernel"],
        "max_abs_err": max(ssd_err, mamba_prefill["layer_err"]["ssd_chunk"],
                           moe[JAMBA]["layer_err"]["ssd_chunk"]),
        "ms": t2["ms"], "plain_ms": t2["plain_ms"],
        "bound_ms": t2["bound_ms"], "bound_by": t2["bound_by"],
        "library_ms": t2["library_ms"],
        "hmma": sass["ssd_chunk"]["HMMA"], "hgmma": sass["ssd_chunk"]["HGMMA"],
        "moe_launches": {JAMBA: moe[JAMBA]["launches"]["ssd_chunk_kernel"]},
        "mesh_launches": mesh["mamba_prefill"]["launches"]["ssd_chunk_kernel"]}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:146",
        "launches": train["launches"],
        "max_abs_err": max(bwd_err, d256_err["bwd"], seq_err,
                           *(t["layer_err"]["bwd"] for t in arch_train.values())),
        "ms": t3["ms"], "plain_ms": t3["plain_ms"],
        "bound_ms": t3["bound_ms"], "bound_by": t3["bound_by"],
        "library_ms": t3["library_ms"],
        "hgmma": sass["flash_attention_bwd"]["HGMMA"],
        "d128": t3["d128"], "d256": t4["bwd"], "d256_cap0": t4["bwd_cap0"],
        "wgmma_kernels": sass["flash_attention_bwd"]["wgmma"],
        "arch_train_launches": {a: t["per_step"]["flash_attention_bwd"]
                                for a, t in arch_train.items()},
        "arch_shapes": {a: t["bwd"] for a, t in t6.items() if "bwd" in t},
        "seq_shards": {k: {"unsharded_ms": x["unsharded_bwd_ms"],
                           "rank_ms": [r["bwd_ms"] for r in x["ranks"]],
                           "last_rank_library_ms": x["ranks"][-1]["sdpa"][
                               "bwd"][1],
                           "last_rank_plain_ms": x["ranks"][-1]["plain_ms"][
                               "bwd"]}
                       for k, x in seq.items()},
        "mesh_launches": mesh["train"]["launches"]["flash_attention_bwd"],
        "world_launches": world["a"]["launches"]["train_step"][
            "flash_attention_bwd"],
        "world_train_launches": train_world["per_step"][
            "flash_attention_bwd"]}, {
        "name": "ssd_chunk_bwd_kernel", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
        "replaces": "src/repro/kernels/ops.py:89",
        "launches": mamba_train["launches"],
        "per_step": mamba_train["per_step"]["ssd_chunk_bwd_kernel"],
        "max_abs_err": ssd_bwd_err,
        "ms": t5["ms"], "plain_ms": t5["plain_ms"],
        "bound_ms": t5["bound_ms"], "bound_by": t5["bound_by"],
        "library_ms": t5["library_ms"], "scan_bwd_ms": t5["scan_bwd_ms"],
        "hmma": sass["ssd_chunk_bwd"]["HMMA"], "hgmma": sass["ssd_chunk_bwd"]["HGMMA"],
        "moe_launches": {JAMBA: jamba_route["launches"]["ssd_chunk_bwd_kernel"]}}, {
        "name": "ssd_pass_kernel", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_pass.cu",
        "replaces": "none: the loop over chunks after K2 (ops.ssd)",
        "launches": mamba_prefill["launches"]["ssd_pass_kernel"],
        "per_step": mamba_train["per_step"]["ssd_pass_kernel"],
        "max_abs_err": max(pass_err, mamba_prefill["layer_err"]["ssd_pass"],
                           moe[JAMBA]["layer_err"]["ssd_pass"]),
        **t7["ssd_pass_kernel"], "hmma": sass["ssd_pass"]["HMMA"]}, {
        "name": "ssd_pass_bwd_kernel", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_pass.cu",
        "replaces": "none: autograd through that loop",
        "launches": mamba_train["per_step"]["ssd_pass_bwd_kernel"]
        * MAMBA_TRAIN_STEPS,
        "per_step": mamba_train["per_step"]["ssd_pass_bwd_kernel"],
        "max_abs_err": pass_err, **t7["ssd_pass_bwd_kernel"],
        "hmma": sass["ssd_pass"]["HMMA"]}]
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f}s "
        f"({card})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _timed(fn):
    """``fn`` logging its own seconds when it returns: where a run's time
    goes, phase by phase (nested phases log their own)."""
    def run(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        log(f"[phase] {fn.__name__} {time.perf_counter() - t0:.1f}s")
        return out
    run.__name__ = fn.__name__
    return run


for _name in [n for n in globals() if n.startswith("phase_")]:
    globals()[_name] = _timed(globals()[_name])


if __name__ == "__main__":
    main()
