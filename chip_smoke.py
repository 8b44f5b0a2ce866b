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
  6. timings with CUDA events: each kernel, its plain version, one PyTorch
     library call as a yardstick where one computes the same function, the
     prefill steps, serve throughput, peak memory.
Every main path is driven with all launch counts set to 0 just before it
and read just after.  It prints one JSON line {"kernels": [...]} and, as
its last line, {"ok": true, "device": {...}}.  Without a CUDA card, or
without the port's sources beside it, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import dataclasses
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
    B, S, Hq, Hkv, D = shape
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s, np.float32))
                 .to("cuda", dtype)
                 for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))


def kernel_counters():
    """The launch counter of each kernel wrapper, by kernel name."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.ssd import ssd_chunk_kernel
    return {"flash_attention_fwd": flash_attention_fwd,
            "ssd_chunk_kernel": ssd_chunk_kernel}


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
    libs = _build.build()
    log(f"[build] {len(libs)} source(s) in {time.time() - t0:.1f}s: "
        + ", ".join(p.name for p in libs.values()))
    for name in libs:
        log(f"[build] nvcc -Xptxas -v, {name}:\n{_build.build_log(name)}")
    for name, lib in libs.items():
        counts = tensor_core_instructions(lib)
        log(f"[build] {name}: tensor-core instructions in the SASS "
            + ", ".join(f"{op} {n}" for op, n in counts.items()))
        if not any(counts.values()):
            raise AssertionError(f"{name}: no tensor-core instruction in "
                                 f"{lib.name}")


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
    for shape in SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = qkv(shape, dtype, seed=0)
            for window, cap in WINDOW_CAP:
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
    log(f"[kernel] sweep of {len(SWEEP)} shapes x 2 dtypes x 4 window/cap: "
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


def prefill_with(name, route, prefill, params, batch):
    """Run ``prefill`` with ``ops.<name>`` replaced by ``route``."""
    from repro_torch.kernels import ops
    kernel_route = getattr(ops, name)
    setattr(ops, name, route)
    try:
        return prefill(params, batch)
    finally:
        setattr(ops, name, kernel_route)


def param_count(params):
    return sum(t.numel() for t in params.values() if torch.is_tensor(t)) + sum(
        t.numel() for layer in params["layers"] for part in layer.values()
        for t in (part.values() if isinstance(part, dict) else [part]))


def phase_prefill(cfg, params, route, kernel, plain, check, tol, seed):
    """A main path: ``make_prefill_step`` at full width (bf16, B=8, S=1024).

    Every launch count is set to 0 just before the step and read just after
    it: ``kernel`` must have launched once per layer and no other kernel at
    all.  Then, on the same batch, every layer's kernel output against
    ``plain`` on that layer's own inputs (``check`` raises beyond ``tol``),
    the last-token logits with ``ops.<route>`` replaced by ``plain``
    (PREFILL_TOL), and the step's time.
    """
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    n = param_count(params)
    assert n == cfg.param_count(), (n, cfg.param_count())
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (PREFILL_B, PREFILL_S))).cuda()}
    prefill = M.make_prefill_step(cfg)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()                            # the main path starts here
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    counts = read_launches()                    # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    if counts != {k: cfg.num_layers if k == kernel else 0 for k in counts}:
        raise AssertionError(f"{cfg.name} prefill launched {counts}, expected "
                             f"{cfg.num_layers} {kernel} and nothing else")
    if logits.shape != (PREFILL_B, 1, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"{cfg.name} prefill logits {tuple(logits.shape)} "
                             "not finite or of the wrong shape")
    if len(cache) != cfg.num_layers or \
            not all(bool(torch.isfinite(t).all()) for c in cache for t in c):
        raise AssertionError(f"{cfg.name} prefill cache not finite")
    log(f"[prefill] {cfg.name} ({n} params) bf16 B={PREFILL_B} S={PREFILL_S}: "
        f"{counts[kernel]} {kernel} launches, peak {peak / 2**30:.2f} GiB")

    # every layer's kernel output against the plain version on the layer's
    # own inputs: the main path's activations
    errs = []
    kernel_route = getattr(ops, route)

    def checked(*args, **kw):
        out = kernel_route(*args, **kw)
        errs.append(check(out, plain(*args, **kw), f"layer {len(errs)}"))
        return out

    prefill_with(route, checked, prefill, params, batch)
    layer_err = max(errs)
    log(f"[prefill] {cfg.name} per layer, kernel vs plain on the layer's own "
        f"inputs: {len(errs)} layers, max |diff| {layer_err:.4g} (tol {tol} "
        "abs + rel)")

    # the whole step through the plain version
    plain_logits, _ = prefill_with(route, plain, prefill, params, batch)
    torch.cuda.synchronize()
    err = float((logits.float() - plain_logits.float()).abs().max())
    agree = float((logits.argmax(-1) == plain_logits.argmax(-1)).float().mean())
    log(f"[prefill] {cfg.name} last-token logits, kernel vs plain: max |diff| "
        f"{err:.4g} (tol {PREFILL_TOL}, max |logit| "
        f"{float(plain_logits.float().abs().max()):.4g}), argmax agreement "
        f"{agree:.3f}")
    if not err <= PREFILL_TOL:
        raise AssertionError(f"{cfg.name} prefill kernel vs plain: {err} > "
                             f"{PREFILL_TOL}")
    step_ms = cuda_ms(lambda: prefill(params, batch), iters=10, warmup=2)
    log(f"[prefill] {cfg.name} step {step_ms:.3f} ms")
    return {"launches": counts[kernel], "step_ms": step_ms, "peak_bytes": peak,
            "layer_err": layer_err}


def phase_prefill_vs_decode(cfg, params, kernel, B, S, seed):
    """f32 prefill through the kernel against S token-by-token decode steps:
    0.1 and equal argmax, the contract of tests/test_models_smoke.py."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    toks = torch.from_numpy(
        np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))).cuda()
    reset_launches()
    logits_p, _ = M.make_prefill_step(cfg)(params, {"tokens": toks})
    torch.cuda.synchronize()
    counts = read_launches()
    if counts[kernel] != cfg.num_layers:
        raise AssertionError(f"{cfg.name} f32 prefill launched {counts}")
    decode = M.make_decode_step(cfg)
    cache = T.init_cache(cfg, B, S, "float32", device="cuda")
    for t in range(S):
        lg, cache = decode(params, toks[:, t:t + 1], cache, t)
    torch.cuda.synchronize()
    err, ok = max_excess(lg, logits_p, 0.1)
    same = bool((lg.argmax(-1) == logits_p.argmax(-1)).all())
    log(f"[decode] {cfg.name} f32 B={B} S={S}: prefill (kernel) vs "
        f"token-by-token decode max |diff| {err:.3g}, argmax equal {same}")
    if not (ok and same and torch.isfinite(lg).all()):
        raise AssertionError(f"{cfg.name} prefill and decode disagree at full "
                             "width")


def phase_serve(arch):
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--requests", "8", "--batch-slots", "4",
            "--max-new", "16"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outputs = serve.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if len(outputs) != 8 or not all(len(v) >= 1 for v in outputs.values()):
        raise AssertionError(f"serve {arch} answered {outputs}")
    generated = sum(len(v) for v in outputs.values())
    log(f"[serve] {arch}: 8/8 requests answered, {generated} tokens generated in "
        f"{seconds:.3f}s (param init included): "
        f"{generated / seconds:.1f} generated tok/s")
    return generated / seconds


def phase_timings(card):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)
    B, S, Hq, Hkv, D = shape = (PREFILL_B, PREFILL_S, 15, 5, 64)
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


def main():
    card = phase_environment()
    phase_build()
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ssd_chunk_plain
    from repro_torch.models import transformer as T
    err = phase_kernel_vs_plain()
    ssd_err = phase_ssd_vs_plain()

    smollm = get_config("smollm-360m")
    prefill = phase_prefill(smollm, smoke_params(smollm, 0), "flash_attention",
                            "flash_attention_fwd", plain_route, check_flash,
                            TOL[torch.bfloat16], seed=2)
    smollm32 = dataclasses.replace(smollm, dtype="float32")
    phase_prefill_vs_decode(smollm32, smoke_params(smollm32, 1),
                            "flash_attention_fwd", B=2, S=32, seed=3)
    serve_tok_s = phase_serve("smollm-360m")

    mamba = get_config("mamba2-1.3b")
    mamba_prefill = phase_prefill(mamba, mamba_smoke_params(mamba, 7),
                                  "ssd_chunk", "ssd_chunk_kernel",
                                  ssd_chunk_plain, check_ssd_terms, SSD_TOL,
                                  seed=5)
    mamba32 = dataclasses.replace(mamba, dtype="float32")
    # two chunks of 256: crosses the recurrence between chunks
    phase_prefill_vs_decode(mamba32, T.init_params(mamba32, 1, device="cuda"),
                            "ssd_chunk_kernel", B=2, S=512, seed=6)
    mamba_serve_tok_s = phase_serve("mamba2-1.3b")

    t = phase_timings(card)
    t2 = phase_ssd_timings(card)
    for arch, pre, tok_s in (("smollm-360m", prefill, serve_tok_s),
                             ("mamba2-1.3b", mamba_prefill, mamba_serve_tok_s)):
        log(f"[timing] {card}: {arch} prefill step {pre['step_ms']:.3f} ms "
            f"(B={PREFILL_B}, S={PREFILL_S}), serve {tok_s:.1f} generated "
            f"tok/s, peak memory in prefill {pre['peak_bytes'] / 2**30:.3f} GiB")
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:114",
        "launches": prefill["launches"],
        "max_abs_err": max(err, prefill["layer_err"]),
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"]}, {
        "name": "ssd_chunk_kernel", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd.py:74",
        "launches": mamba_prefill["launches"],
        "max_abs_err": max(ssd_err, mamba_prefill["layer_err"]),
        "ms": t2["ms"], "plain_ms": t2["plain_ms"],
        "bound_ms": t2["bound_ms"], "bound_by": t2["bound_by"],
        "library_ms": t2["library_ms"]}]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
