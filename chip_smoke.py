#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises on failure:
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: every CUDA source under src/repro_torch/kernels/csrc, all at
     once, with the compiler's register / shared-memory / spill report and
     the count of tensor-core instructions (HMMA, HGMMA) in each library's
     SASS; a library without any fails;
  3. each kernel against its plain PyTorch version on the card, over the
     reference's sweep grids (tests/test_kernels.py) and the main paths'
     shapes: flash attention (K1) and the SSD chunk terms (K2), and
     ``ops.ssd`` from a nonzero state against the step-by-step recurrence;
     the SSD backward (K2b) over the sweep and the mamba2 shape, f32 and
     bf16, and with Mamba2's published dt/A draw (decays past 88 within a
     chunk), each call twice and bitwise equal, and the gradients of
     ``ops.ssd`` (K2, K2b, the recurrence) from a nonzero state, dh0
     included, against autograd through the recurrence;
  4. smollm-360m prefill at full width (bf16, B=8, S=1024) through
     ``make_prefill_step``, with every kernel launch counted, and its
     logits against the same step through the plain attention; then
     prefill against token-by-token decode at full width in f32, and the
     serve loop at full width (``repro_torch.launch.serve.main``);
  5. the same for mamba2-1.3b: prefill at full width (bf16, B=8, S=1024,
     48 SSD chunk kernel launches, dt and A drawn as Mamba2's published
     init draws them: ``mamba_smoke_params``), kernel route against plain
     route per layer and in the logits; f32 prefill (B=2, S=512, two
     chunks) against 512 decode steps; the serve loop;
  6. training (smollm-360m): K1 writing its lse against its plain version,
     and the flash backward K1b against its plain version over the sweep
     grid, the training shape (B=8, S=1024), a D=128 shape (B=4, S=1024,
     Hq=16, Hkv=8) and shapes with rows that see no key (Sq > Skv and a
     window), each call run twice and required bitwise equal; on those
     rows K1 and K1b held to their contract (o = 0, lse = -1e30, no
     gradient); K1 and K1b at head dim 256, gemma2-9b's attention shape
     (B=1, S=8192, Hq=16, Hkv=8, cap 50, the 4096 window and none), f32
     and bf16, against their plain versions, K1b twice and bitwise equal;
     one loss-and-grad at full width (4 layers, f32) by the kernel route
     against the plain route; then the train driver
     (``repro_torch.launch.train.main``) at full width in bf16 through the
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
     steps on one batch: 96 K2 and 48 K2b launches a step, the loss
     falling, step time and peak), then the train driver on it (2
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
  8. timings with CUDA events: each kernel, its plain version, one PyTorch
     library call as a yardstick where one computes the same function, K1
     with and without its lse, K1b at D=64 and D=128 beside SDPA's
     backward, K1 and K1b at gemma2's D=256 shape beside SDPA's forward
     and backward, K2b and the whole SSD backward at the mamba2 shape,
     the prefill and train steps (a train_segment task's time beside the
     same steps called directly), serve throughput, peak memory.
Every main path is driven with all launch counts set to 0 just before it
and read just after.  It prints one JSON line {"kernels": [...]} and, as
its last line, {"ok": true, "device": {...}}.  Without a CUDA card, or
without the port's sources beside it, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
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
# flash backward, kernel against plain: f32 5e-5 is the reference's own
# tolerance for its VJP (tests/test_kernels.py); bf16 3e-2 as the forward's
BWD_TOL = {torch.float32: 5e-5, torch.bfloat16: 3e-2}
# and per tensor, ||kernel - plain|| / ||plain||: most of the training
# shape's gradients are small, where 3e-2 elementwise is loose; the bf16
# rounding of p and ds moves the norm by a few 1e-3 (PERF.md)
BWD_NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
TRAIN_SHAPE = (PREFILL_B, PREFILL_S, 15, 5, 64)   # smollm-360m, B=8, S=1024
D128_SHAPE = (4, 1024, 16, 8, 128)                # internlm2-like heads
# rows that see no key: (B, Sq, Skv, Hq, Hkv, D), causal, window 13; rows
# from Skv + 12 on see none.  D=16 is the shape of
# tests/test_torch_flash_nokey.py; D=64 and 128 reach K1b's wgmma path
NOKEY_SHAPES = [(1, 96, 32, 2, 1, 16), (1, 96, 32, 2, 1, 64),
                (1, 160, 32, 4, 2, 128)]
NOKEY_WINDOW = 13
# train route comparison, f32 at full width, 4 layers, B=2, S=256: loss
# within 1e-4, each grad leaf within 1e-3 of its largest magnitude
ROUTE_LAYERS, ROUTE_B, ROUTE_S = 4, 2, 256
ROUTE_LOSS_TOL, ROUTE_GRAD_TOL = 1e-4, 1e-3
TRAIN_ARGV = ["--arch", "smollm-360m", "--batch", "8", "--seq", "1024",
              "--segment", "2", "--ckpt-every", "2", "--eval-every", "4"]
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
# (HMMA) in K1, K2 and K2b's bf16 path (its f32 operands split in three
# bf16 parts), wgmma (HGMMA) in K1b's bf16 path at D = 64 and 128.  Every
# built library needs an entry
TENSOR_CORE_OPS = {"flash_attention_fwd": ("HMMA",), "ssd_chunk": ("HMMA",),
                   "flash_attention_bwd": ("HGMMA",), "ssd_chunk_bwd": ("HMMA",)}
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
    return {"flash_attention_fwd": flash_attention_fwd,
            "flash_attention_bwd": flash_attention_bwd,
            "ssd_chunk_kernel": ssd_chunk_kernel,
            "ssd_chunk_bwd_kernel": ssd_chunk_bwd_kernel}


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
    for name, lib in libs.items():
        counts[name] = tensor_core_instructions(lib)
        log(f"[build] {name}: tensor-core instructions in the SASS "
            + ", ".join(f"{op} {n}" for op, n in counts[name].items())
            + f" (required: {', '.join(TENSOR_CORE_OPS[name]) or 'none'})")
        missing = [op for op in TENSOR_CORE_OPS[name] if not counts[name][op]]
        if missing:
            raise AssertionError(f"{name}: no {', '.join(missing)} in "
                                 f"{lib.name}'s SASS")
    return counts


def tensor_core_instructions(lib):
    """HMMA (mma.sync) and HGMMA (wgmma) instructions in a library's SASS,
    from ``cuobjdump -sass``."""
    cuda_bin = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin"
    tool = shutil.which("cuobjdump") or str(cuda_bin / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    lines = sass.splitlines()
    return {op: sum(1 for line in lines if re.search(rf"\b{op}\b", line))
            for op in ("HMMA", "HGMMA")}


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
    """Within TOL of the plain version; returns the largest |kernel - plain|."""
    err, ok = max_excess(got, want, TOL[got.dtype])
    if not ok:
        raise AssertionError(f"flash_attention_fwd {what}: max |kernel-plain| "
                             f"{err} over tol {TOL[got.dtype]}")
    return err


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
    """A prefill's launches: K1 once per attention layer, K2 once per
    mamba layer, nothing else.  With ``train``, one loss-and-grad under
    remat "full": K1 and K2 twice per layer of their kind (the forward and
    its recompute in the backward), K1b and K2b once."""
    from repro_torch.models import transformer as T
    n_attn = sum(kind in ("attn", "local_attn")
                 for kind, _ in T.layer_program(cfg))
    n_ssd = cfg.num_layers - n_attn
    if train:
        return {"flash_attention_fwd": 2 * n_attn,
                "flash_attention_bwd": n_attn, "ssd_chunk_kernel": 2 * n_ssd,
                "ssd_chunk_bwd_kernel": n_ssd}
    return {"flash_attention_fwd": n_attn, "flash_attention_bwd": 0,
            "ssd_chunk_kernel": n_ssd, "ssd_chunk_bwd_kernel": 0}


def param_count(params):
    return sum(t.numel() for t in params.values() if torch.is_tensor(t)) + sum(
        t.numel() for layer in params["layers"] for part in layer.values()
        for t in (part.values() if isinstance(part, dict) else [part]))


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
    """Rows that see no key, on the card: K1 writes o = 0 there, with and
    without its lse, and lse = -1e30; K1b gives them dq = 0, and a nonzero
    do on those rows leaves dk and dv bitwise as they are with do = 0
    there (p = 0 and ds = 0 on all their entries)."""
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
    50, at today's tolerances; K1b run twice and bitwise equal; every call
    launches its kernel."""
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
            for name, g, w in (("o", o, want_o), ("lse", lse, want_lse)):
                err, ok = max_excess(g, w, TOL[dtype])
                if not ok:
                    raise AssertionError(f"flash_attention_fwd {what}: {name} "
                                         f"max |kernel-plain| {err} over tol "
                                         f"{TOL[dtype]}")
                worst["fwd", dtype] = max(worst.get(("fwd", dtype), 0.0), err)
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
                       else f"{e:.3g}")
                    for (k, dt), e in worst.items()))
    return {"fwd": max(e for (k, _), e in worst.items() if k == "fwd"),
            "bwd": max(e[0] for (k, _), e in worst.items() if k == "bwd")}


def phase_d256_timings(card):
    """K1 and K1b (bf16) at gemma2-9b's attention shape, with its cap and
    no window (a global layer), beside SDPA's forward and backward at the
    same shape (causal, no cap: SDPA has none), in turns."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    B, S, Hq, Hkv, D = GEMMA_SHAPE
    q, k, v = qkv(GEMMA_SHAPE, torch.bfloat16, seed=17)
    do = qkv(GEMMA_SHAPE, torch.bfloat16, seed=18)[0]
    kw = dict(causal=True, attn_softcap=GEMMA_CAP)
    o, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    fwd = lambda: flash_attention_fwd(q, k, v, **kw)
    lib_fwd = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    out = lib_fwd()
    dot = do.transpose(1, 2)
    bwd = lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw)
    lib_bwd = lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                          retain_graph=True)
    res = {}
    pairs = S * (S + 1) // 2
    for name, kern, lib, products, nbytes in (
            ("fwd", fwd, lib_fwd, 2,
             (2 * q.numel() + k.numel() + v.numel()) * q.element_size()),
            ("bwd", bwd, lib_bwd, 5,
             (4 * q.numel() + 4 * k.numel()) * q.element_size()
             + 4 * lse.numel())):
        t_k = [cuda_ms(kern, iters=10)]
        t_l = [cuda_ms(lib, iters=10), cuda_ms(lib, iters=10)]
        t_k.append(cuda_ms(kern, iters=10))
        flops = 2 * products * D * pairs * B * Hq
        t_ops = flops / H100_BF16_FLOPS * 1e3
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        bound_ms = max(t_ops, t_bytes)
        ms = sum(t_k) / 2
        res[name] = {"ms": ms, "library_ms": sum(t_l) / 2,
                     "bound_ms": bound_ms,
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        log(f"[timing] {card}: flash_attention_{name} D=256 {GEMMA_SHAPE} "
            f"bf16 causal cap {GEMMA_CAP}: {t_k[0]:.4f} / {t_k[1]:.4f} ms; "
            f"{flops / 1e9:.3f} GFLOP ({products} products), "
            f"{nbytes / 1e6:.2f} MB; bound {bound_ms:.4f} ms "
            f"({res[name]['bound_by']}), {100 * bound_ms / ms:.2f}% of bound; "
            f"scaled_dot_product_attention {name} (causal, no cap) "
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
    worst = {}
    cases = ([(shape, dtype, ssd_inputs) for shape in SSD_SWEEP + [MAMBA_SHAPE]
              for dtype in (torch.float32, torch.bfloat16)]
             + [(MAMBA_SHAPE, torch.bfloat16, published_ssd_inputs)])
    for shape, dtype, inputs in cases:
        args = inputs(shape, dtype, seed=40)
        cts = ssd_cotangents(shape, seed=41)
        got = ssd_chunk_bwd_kernel(*args, *cts, chunk=shape[-1])
        again = ssd_chunk_bwd_kernel(*args, *cts, chunk=shape[-1])
        torch.cuda.synchronize()
        want = ssd_chunk_bwd_plain(*args, *cts, chunk=shape[-1])
        # the same function on the inputs upcast (exactly) to f32: dx's f32
        # sum before its one rounding
        dx32 = ssd_chunk_bwd_plain(*(t.float() for t in args), *cts,
                                   chunk=shape[-1])[0]
        key = ("sweep" if shape != MAMBA_SHAPE else "mamba2 shape"
               if inputs is ssd_inputs else "mamba2 shape, published dt/A",
               dtype)
        e, r = check_ssd_grads(got, again, want, f"{key[0]} {shape} {dtype}",
                               dx32)
        e0, r0 = worst.get(key, (0.0, 0.0))
        worst[key] = (max(e0, e), max(r0, r))
        del got, again, want, dx32
    log(f"[kernel] ssd_chunk_bwd_kernel, {len(SSD_SWEEP)} sweep shapes and "
        f"the mamba2 shape {MAMBA_SHAPE} x f32/bf16, and the mamba2 shape "
        "with the published dt/A draw, dx ddt dA dB dC each run twice and "
        "bitwise equal: "
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
    twice per layer, K2b once) against the plain route, ``ops.ssd_chunk``
    and ``ops.ssd_chunk_grads`` replaced by their plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ssd_chunk_bwd_plain, ssd_chunk_plain
    cfg = dataclasses.replace(get_config(MAMBA), dtype="float32",
                              num_layers=MAMBA_ROUTE_LAYERS)
    out = route_compare(
        f"{MAMBA} f32 {MAMBA_ROUTE_LAYERS} layers B={MAMBA_ROUTE_B} "
        f"S={MAMBA_ROUTE_S}", cfg, mamba_smoke_params(cfg, 44),
        train_batch(cfg, MAMBA_ROUTE_B, MAMBA_ROUTE_S, 45),
        {"ssd_chunk": ssd_chunk_plain, "ssd_chunk_grads": ssd_chunk_bwd_plain})
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
    passes 88, where the reference's backward gives NaN).  Each step: K2 96
    launches (the forward and its recompute), K2b 48, nothing else; the
    loss finite every step and lower at step 5 than at step 1.  Then the
    train driver (``repro_torch.launch.train.main``) on the same arch, 2
    segments of 2 steps through the runtime, launches counted around the
    run and inside each segment's body."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.optim import AdamW, cosine_schedule
    cfg = get_config(MAMBA)
    L = cfg.num_layers
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

    ckpt = ROOT / "build" / "chip_smoke_ckpt_mamba"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        reset_launches()                        # the main path starts here
        rec = {}
        d_losses = train.main(MAMBA_TRAIN_ARGV + ["--ckpt-dir", str(ckpt)], rec)
        torch.cuda.synchronize()
        d_counts = read_launches()              # ... and ends here
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    # 4 steps and one evaluation (forward only: K2 once per layer)
    d_want = {"flash_attention_fwd": 0, "flash_attention_bwd": 0,
              "ssd_chunk_kernel": 2 * L * 4 + L, "ssd_chunk_bwd_kernel": L * 4}
    tasks = segment_tasks(rec)
    log(f"[train] {MAMBA} driver, 4 steps in 2 segments through the runtime: "
        f"losses {d_losses}, launches {d_counts} (expected {d_want}), "
        f"{seconds:.1f}s with a checkpoint; peak after each segment "
        + ", ".join(f"{s['peak_bytes'] / 2**30:.3f}" for s in rec["segments"])
        + " GiB; launches inside each train_segment body "
        + ", ".join(str(t["launches"]) for t in tasks))
    if d_counts != d_want or len(d_losses) != 2 or \
            not all(np.isfinite(d_losses)):
        raise AssertionError(f"{MAMBA} driver: losses {d_losses}, launches "
                             f"{d_counts}, expected {d_want}")
    for t in tasks:
        if t["launches"]["ssd_chunk_bwd_kernel"] != L * sum(t["steps"]):
            raise AssertionError(f"{MAMBA} driver: {t['uid']} launched "
                                 f"{t['launches']} inside its body")
    return {"losses": losses, "launches": sum(c["ssd_chunk_bwd_kernel"]
                                              for c in counts),
            "per_step": counts[0], "step_ms": step_ms, "times": times,
            "tok_s": tok_s, "peak_bytes": peak, "params": n,
            "driver": {"losses": d_losses, "counts": d_counts,
                       "seconds": seconds, "tasks": tasks}}


def phase_jamba_train_route():
    """jamba-1.5-large-398b at its reduced config, f32, B=2, S=256 (32 SSD
    chunks of 8), attention rescaled as ``smoke_params`` does and dt, A
    drawn as Mamba2's published init draws them: loss and grad by the
    kernel route (K1 with lse and K1b in its 2 attention layers, K2 and K2b
    in its 14 mamba layers) against the plain route with every kernel
    replaced, the expert choices of each MoE call replayed."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.kernels.ref import (flash_attention_bwd_plain,
                                         flash_attention_lse_plain)
    from repro_torch.kernels.ssd import ssd_chunk_bwd_plain, ssd_chunk_plain
    from tools.mamba_sensitivity import published_dt_a
    cfg = dataclasses.replace(reduce_config(get_config(JAMBA)), dtype="float32")
    return route_compare(
        f"{JAMBA} reduced f32 B={ROUTE_B} S={ROUTE_S}", cfg,
        published_dt_a(smoke_params(cfg, 48), 48),
        train_batch(cfg, ROUTE_B, ROUTE_S, 49),
        {"flash_attention_lse": flash_attention_lse_plain,
         "flash_attention_grads": flash_attention_bwd_plain,
         "ssd_chunk": ssd_chunk_plain, "ssd_chunk_grads": ssd_chunk_bwd_plain})


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
    width in bf16, B=8, S=1024, through the runtime: ``train_segment``
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
    step there.  The device's peak after each segment must not grow by a
    training state (3.6 GB) from segment to segment.  The runtime's
    overhead comes from the pilot's event stream."""
    from repro_torch.configs import get_config
    from repro_torch.core import overhead_from_events
    from repro_torch.launch import train
    cfg = get_config("smollm-360m")
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
            argv = TRAIN_ARGV + ["--steps", str(steps)] + extra
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
                    "ssd_chunk_bwd_kernel": 0}
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


def phase_prefill(cfg, params, routes, seed):
    """A main path: ``make_prefill_step`` at full width (bf16, B=8, S=1024).

    ``routes``: (ops name, plain version, check, tol) of each kernel the
    path runs.  Every launch count is set to 0 just before the step and
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
    n = param_count(params)
    if n != cfg.param_count():
        raise AssertionError(f"{cfg.name}: {n} params, config says "
                             f"{cfg.param_count()}")
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (PREFILL_B, PREFILL_S))).cuda()}
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
    if logits.shape != (PREFILL_B, 1, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"{cfg.name} prefill logits {tuple(logits.shape)} "
                             "not finite or of the wrong shape")
    if len(cache) != cfg.num_layers or \
            not all(bool(torch.isfinite(t).all()) for c in cache for t in c):
        raise AssertionError(f"{cfg.name} prefill cache not finite")
    del cache
    log(f"[prefill] {cfg.name} ({n} params, {cfg.num_layers} layers) bf16 "
        f"B={PREFILL_B} S={PREFILL_S}: launches {counts}, peak "
        f"{peak / 2**30:.2f} GiB")
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
        layer_err[name] = max(errs)
        log(f"[prefill] {cfg.name} per layer, {name} kernel vs plain on the "
            f"layer's own inputs: {len(errs)} layers, max |diff| "
            f"{layer_err[name]:.4g} (tol {tol} abs + rel)")

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
    step_ms = cuda_ms(lambda: prefill(params, batch), iters=10, warmup=2)
    log(f"[prefill] {cfg.name} step {step_ms:.3f} ms")
    return {"launches": counts, "step_ms": step_ms, "peak_bytes": peak,
            "layer_err": layer_err, "batch": batch, "logits": logits}


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
    res = phase_prefill(cfg, params, [("flash_attention", plain_route,
                                       check_flash, TOL[torch.bfloat16])],
                        seed)
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
    t_e = [cuda_ms(run["einsum"], iters=10)]
    t_g = [cuda_ms(run["gather"], iters=10), cuda_ms(run["gather"], iters=10)]
    t_e.append(cuda_ms(run["einsum"], iters=10))
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
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)
    B, S, Hq, Hkv, D = shape
    q, k, v = qkv(shape, torch.bfloat16, seed=1)
    ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, causal=True), iters=20)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True),
                       iters=5, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), iters=20)
    pairs = S * (S + 1) // 2                    # causal (q, kv) pairs per head
    flops = 4 * D * pairs * B * Hq              # q.k and p.v, 2 flops per MAC
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    log(f"[timing] {card}: flash_attention_fwd {shape} bf16 causal: "
        f"{ms:.4f} ms; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB; bound "
        f"{bound_ms:.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'}), "
        f"{100 * bound_ms / ms:.2f}% of bound; plain {plain_ms:.4f} ms; "
        f"scaled_dot_product_attention {library_ms:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


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
    # in turns, plain order then reversed: without, with, with, without
    t_no = [cuda_ms(fwd, iters=20)]
    t_lse = [cuda_ms(fwd_lse, iters=20), cuda_ms(fwd_lse, iters=20)]
    t_no.append(cuda_ms(fwd, iters=20))
    log(f"[timing] {card}: flash_attention_fwd {shape} bf16 causal without "
        f"lse {t_no[0]:.4f} / {t_no[1]:.4f} ms, with lse {t_lse[0]:.4f} / "
        f"{t_lse[1]:.4f} ms (in turns: without, with, with, without)")
    bwd = bwd_timing(card, TRAIN_SHAPE, seed=7, plain=True)
    d128 = bwd_timing(card, D128_SHAPE, seed=14, plain=False)

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


def bwd_timing(card, shape, seed, plain):
    """K1b (bf16, causal) at ``shape`` against the backward of SDPA on the
    same inputs, in turns (kernel, library, library, kernel), and its plain
    version where ``plain``; the bound counts the five products a backward
    needs, and q k v o do lse in, dq dk dv out."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_fwd)
    B, S, Hq, Hkv, D = shape
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
    t_k = [cuda_ms(kernel, iters=20)]
    t_l = [cuda_ms(library, iters=20), cuda_ms(library, iters=20)]
    t_k.append(cuda_ms(kernel, iters=20))
    ms, library_ms = sum(t_k) / 2, sum(t_l) / 2
    plain_ms = (cuda_ms(lambda: flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal=True), iters=3, warmup=1)
        if plain else None)
    pairs = S * (S + 1) // 2
    flops = 2 * 5 * D * pairs * B * Hq          # five products, 2 per MAC
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + 4 * lse.numel()
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"[timing] {card}: flash_attention_bwd {shape} bf16 causal: "
        f"{t_k[0]:.4f} / {t_k[1]:.4f} ms; {flops / 1e9:.3f} GFLOP (5 "
        f"products; the kernel runs 7), {nbytes / 1e6:.2f} MB; bound "
        f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.2f}% of "
        f"bound; plain "
        + (f"{plain_ms:.4f} ms" if plain else "not timed")
        + f"; scaled_dot_product_attention backward {t_l[0]:.4f} / "
        f"{t_l[1]:.4f} ms (torch.autograd.grad through "
        f"{out.grad_fn.name()}, is_causal, enable_gqa, on a kept graph; in "
        "turns: kernel, library, library, kernel)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


SSD_TERMS = ("y_intra", "states", "decay_all", "decay_chunk")


def ssd_inputs(shape, dtype, seed):
    """x, dt, A, B_, C_ for the SSD chunk terms; x, B_ and C_ are split
    views of one (B, S, H*P + 2N) tensor, as ``mamba_layer`` hands them to
    the kernel.  At the sweep's shapes they are drawn as the reference's
    sweep draws them.  At the mamba2 shape they are drawn at the model's
    scale (tools/ssd_conditioning.py, draw "model"): with unit-normal x, B,
    C and N = 128 a 256-long chunk sums terms of up to ~500, and f32
    rounding on either route alone then misses a float64 truth by more
    than 5e-4 (that tool measures it)."""
    from tools.ssd_conditioning import draw
    B, S, H, P, N, _ = shape
    return draw(B, S, H, P, N, dtype,
                "model" if shape == MAMBA_SHAPE else "sweep", seed)


def check_ssd_terms(got, want, what):
    """Each term finite and within SSD_TOL of the plain version; returns the
    largest |kernel - plain|."""
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
    return worst


def phase_ssd_vs_plain():
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_sequential
    from repro_torch.kernels.ssd import ssd_chunk_kernel, ssd_chunk_plain
    worst = {}
    for shape in SSD_SWEEP + [MAMBA_SHAPE]:
        for dtype in (torch.float32, torch.bfloat16):
            args = ssd_inputs(shape, dtype, seed=0)
            got = ssd_chunk_kernel(*args, chunk=shape[-1])
            torch.cuda.synchronize()
            want = ssd_chunk_plain(*args, chunk=shape[-1])
            err = check_ssd_terms(got, want, f"{shape} {dtype}")
            key = "mamba2 shape" if shape == MAMBA_SHAPE else "sweep"
            worst[key, dtype] = max(worst.get((key, dtype), 0.0), err)
    log(f"[kernel] ssd_chunk_kernel, {len(SSD_SWEEP)} sweep shapes and the "
        f"mamba2 shape {MAMBA_SHAPE} x f32/bf16, 4 terms each, all finite: "
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


def phase_ssd_timings(card):
    from repro_torch.kernels.ssd import ssd_chunk_kernel, ssd_chunk_plain
    B, S, H, P, N, Q = MAMBA_SHAPE
    args = ssd_inputs(MAMBA_SHAPE, torch.bfloat16, seed=3)
    x, dt, A = args[:3]
    ms = cuda_ms(lambda: ssd_chunk_kernel(*args, chunk=Q), iters=20)
    plain_ms = cuda_ms(lambda: ssd_chunk_plain(*args, chunk=Q), iters=5,
                       warmup=1)
    nc, tri = S // Q, Q * (Q + 1) // 2          # (i, j <= i) pairs per chunk
    # C B^T once per (b, chunk), M x per (b, h, chunk), the state per
    # (b, h, chunk); 2 flops per multiply-add
    flops = 2 * (N * B * nc * tri + P * B * H * nc * tri + B * H * nc * Q * P * N)
    elt = x.element_size()
    nbytes = ((B * S * H * P + 2 * B * S * N) * elt + 4 * (dt.numel() + A.numel())
              + 4 * (B * S * H * P + B * H * nc * (P * N + Q + 1)))
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
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
    from repro_torch.kernels.ssd import (ssd_chunk_bwd_kernel,
                                         ssd_chunk_bwd_plain)
    B, S, H, P, N, Q = MAMBA_SHAPE
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
    nc, tri = S // Q, Q * (Q + 1) // 2
    flops = 2 * (3 * N * B * nc * tri + 2 * P * B * H * nc * tri
                 + 2 * B * H * nc * Q * P * N)
    nbytes = ((B * S * H * P + 2 * B * S * N) * args[0].element_size()
              + 4 * (B * S * H + H)                       # dt, A
              + 4 * (B * S * H * P + B * H * nc * (P * N + Q + 1))   # cotangents
              + B * S * H * P * args[0].element_size()   # dx
              + 4 * (B * S * H + H + 2 * B * S * N))        # ddt dA dB dC
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    ms = sum(t_k) / 2
    log(f"[timing] {card}: ssd_chunk_bwd_kernel {MAMBA_SHAPE} bf16: "
        f"{t_k[0]:.4f} / {t_k[1]:.4f} ms; {flops / 1e9:.3f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB; bound {bound_ms:.4f} ms ({bound_by}), "
        f"{100 * bound_ms / ms:.2f}% of bound; plain {plain_ms:.4f} ms; "
        f"ops.ssd backward through autograd (K2b and the recurrence) "
        f"{scan_ms:.4f} ms; no single PyTorch call computes this backward")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by, "scan_bwd_ms": scan_ms}


def phase_moe(flash, ssd):
    """The MoE archs.  qwen3-moe-235b-a22b at full width cut to 4 of its 94
    layers (20.59 GiB in bf16): the prefill main path, the serve loop on
    the same params; then, its bf16 params freed, 2 layers in f32 (22.91
    GiB) for prefill against decode.  dbrx-132b at full width cut to 2 of
    its 40 layers (14.44 GiB): the prefill main path.  jamba-1.5-large-398b
    at its reduced config only (16 layers, d_model 64): one full-width
    period of 8 layers is 45.14 B params, 84.07 GiB in bf16, more than the
    card holds, and fewer layers than a period drop its attention layer;
    bf16 prefill (2 K1 and 14 K2 launches), f32 prefill against decode, the
    serve loop."""
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
    out[JAMBA] = dict(phase_prefill(cfg, params, [flash, ssd], seed=28),
                      layers=cfg.num_layers)
    del params
    cfg32 = dataclasses.replace(
        cfg, dtype="float32",
        capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    phase_prefill_vs_decode(cfg32, smoke_params(cfg32, 29), B=2, S=32, seed=30)
    out[JAMBA]["serve_tok_s"] = phase_serve(JAMBA, reduced=True)
    return out


def main():
    card = phase_environment()
    sass = phase_build()
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ssd_chunk_plain
    from repro_torch.models import transformer as T
    err = phase_kernel_vs_plain()
    ssd_err = phase_ssd_vs_plain()
    ssd_bwd_err = phase_ssd_bwd_vs_plain()
    lse_err = phase_lse_vs_plain()
    bwd_err = phase_bwd_vs_plain()
    phase_no_key_rows()
    d256_err = phase_d256()

    smollm = get_config("smollm-360m")
    flash = ("flash_attention", plain_route, check_flash, TOL[torch.bfloat16])
    ssd = ("ssd_chunk", ssd_chunk_plain, check_ssd_terms, SSD_TOL)
    prefill = phase_prefill(smollm, smoke_params(smollm, 0), [flash], seed=2)
    smollm32 = dataclasses.replace(smollm, dtype="float32")
    phase_prefill_vs_decode(smollm32, smoke_params(smollm32, 1), B=2, S=32,
                            seed=3)
    serve_tok_s = phase_serve("smollm-360m")

    mamba = get_config("mamba2-1.3b")
    mamba_prefill = phase_prefill(mamba, mamba_smoke_params(mamba, 7), [ssd],
                                  seed=5)
    mamba32 = dataclasses.replace(mamba, dtype="float32")
    # two chunks of 256: crosses the recurrence between chunks
    phase_prefill_vs_decode(mamba32, T.init_params(mamba32, 1, device="cuda"),
                            B=2, S=512, seed=6)
    mamba_serve_tok_s = phase_serve("mamba2-1.3b")

    phase_train_routes()
    train = phase_train_driver()
    mamba_route = phase_mamba_train_route()
    mamba_train = phase_mamba_train(card)
    moe = phase_moe(flash, ssd)
    jamba_route = phase_jamba_train_route()
    qwen_train = phase_qwen_train(card)

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
    log(f"[train] route comparisons, worst grad leaf relative to its largest "
        f"magnitude: {MAMBA} {mamba_route['grad_rel_err']:.3g}, {JAMBA} "
        f"{jamba_route['grad_rel_err']:.3g} (tol {ROUTE_GRAD_TOL})")
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
                           lse_err, d256_err["fwd"],
                           *(m["layer_err"]["flash_attention"]
                             for m in moe.values())),
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"], "d256": t4["fwd"],
        "moe_launches": {a: m["launches"]["flash_attention_fwd"]
                         for a, m in moe.items()},
        "moe_shapes": t_moe}, {
        "name": "ssd_chunk_kernel", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd.py:74",
        "launches": mamba_prefill["launches"]["ssd_chunk_kernel"],
        "max_abs_err": max(ssd_err, mamba_prefill["layer_err"]["ssd_chunk"],
                           moe[JAMBA]["layer_err"]["ssd_chunk"]),
        "ms": t2["ms"], "plain_ms": t2["plain_ms"],
        "bound_ms": t2["bound_ms"], "bound_by": t2["bound_by"],
        "library_ms": t2["library_ms"],
        "moe_launches": {JAMBA: moe[JAMBA]["launches"]["ssd_chunk_kernel"]}}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:146",
        "launches": train["launches"],
        "max_abs_err": max(bwd_err, d256_err["bwd"]),
        "ms": t3["ms"], "plain_ms": t3["plain_ms"],
        "bound_ms": t3["bound_ms"], "bound_by": t3["bound_by"],
        "library_ms": t3["library_ms"],
        "hgmma": sass["flash_attention_bwd"]["HGMMA"],
        "d128": t3["d128"], "d256": t4["bwd"]}, {
        "name": "ssd_chunk_bwd_kernel", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
        "replaces": "src/repro/kernels/ops.py:89",
        "launches": mamba_train["launches"],
        "per_step": mamba_train["per_step"]["ssd_chunk_bwd_kernel"],
        "max_abs_err": ssd_bwd_err,
        "ms": t5["ms"], "plain_ms": t5["plain_ms"],
        "bound_ms": t5["bound_ms"], "bound_by": t5["bound_by"],
        "library_ms": t5["library_ms"], "scan_bwd_ms": t5["scan_bwd_ms"],
        "hmma": sass["ssd_chunk_bwd"]["HMMA"],
        "moe_launches": {JAMBA: jamba_route["launches"]["ssd_chunk_bwd_kernel"]}}]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
