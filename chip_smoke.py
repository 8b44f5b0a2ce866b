#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises on failure:
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: every CUDA source under src/repro_torch/kernels/csrc, with the
     compiler's register / shared-memory / spill report;
  3. each kernel against its plain PyTorch version on the card, over the
     reference's sweep grid (tests/test_kernels.py) and the main path's shape;
  4. the main path: smollm-360m prefill at full width (bf16, B=8, S=1024)
     through ``make_prefill_step``, with every kernel launch counted, and its
     logits against the same step through the plain attention;
  5. prefill against token-by-token decode at full width in f32;
  6. the serve loop at full width (``repro_torch.launch.serve.main``);
  7. timings with CUDA events: kernel, plain version, one PyTorch library
     call as a yardstick, the prefill step, serve throughput, peak memory.
It prints one JSON line {"kernels": [...]} and, as its last line,
{"ok": true, "device": {...}}.  Without a CUDA card, or without the port's
sources beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
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
# tests/test_models_smoke.py).  The two routes round p at different points
# (f32 in the kernel, bf16 in the plain version) in each of 32 layers; with
# the weights of smoke_params that moves the logits by about 0.014 at
# B=2 S=128 on the CPU (tools/prefill_sensitivity.py)
PREFILL_TOL = 0.1


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


def plain_route(q, k, v, **kw):
    """``ops.flash_attention`` through the kernel's plain version."""
    from repro_torch.kernels.ref import attention_reference
    return attention_reference(q, k, v, causal=kw["causal"],
                               window=kw["window"],
                               attn_softcap=kw["attn_softcap"])


def prefill_with(route, prefill, params, batch):
    """Run ``prefill`` with ``ops.flash_attention`` replaced by ``route``."""
    from repro_torch.kernels import ops
    kernel_route = ops.flash_attention
    ops.flash_attention = route
    try:
        return prefill(params, batch)
    finally:
        ops.flash_attention = kernel_route


def phase_prefill():
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models import model as M
    cfg = get_config("smollm-360m")
    params = smoke_params(cfg, 0)
    n = sum(p.numel() for layer in params["layers"]
            for part in layer.values()
            for p in (part.values() if isinstance(part, dict) else [part]))
    n += params["embed"].numel() + params["final_norm"].numel()
    assert n == cfg.param_count(), (n, cfg.param_count())
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (PREFILL_B, PREFILL_S))).cuda()}
    prefill = M.make_prefill_step(cfg)

    torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd.launches = 0            # the main path starts here
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    launches = flash_attention_fwd.launches     # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    if launches != cfg.num_layers:
        raise AssertionError(f"prefill launched flash_attention_fwd {launches} "
                             f"times, expected {cfg.num_layers}")
    if logits.shape != (PREFILL_B, 1, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite "
                             "or of the wrong shape")
    assert len(cache) == cfg.num_layers and cache[0].k.shape == (
        PREFILL_B, PREFILL_S, cfg.num_kv_heads, cfg.head_dim)
    log(f"[prefill] smollm-360m ({n} params) bf16 B={PREFILL_B} "
        f"S={PREFILL_S}: {launches} flash_attention_fwd launches, peak "
        f"{peak / 2**30:.2f} GiB")

    # every layer's kernel output against the plain version on the same
    # q, k, v: the main path's own activations
    errs = []
    kernel_route = ops.flash_attention

    def checked(q, k, v, **kw):
        o = kernel_route(q, k, v, **kw)
        err, ok = max_excess(o, plain_route(q, k, v, **kw), TOL[q.dtype])
        if not ok:
            raise AssertionError(f"layer {len(errs)}: max |kernel-plain| {err}")
        errs.append(err)
        return o

    prefill_with(checked, prefill, params, batch)
    layer_err = max(errs)
    log(f"[prefill] per layer, kernel vs plain on the layer's own q/k/v: "
        f"{len(errs)} layers, max |diff| {layer_err:.4g} (tol "
        f"{TOL[torch.bfloat16]} abs + rel)")

    # the whole step through the plain attention
    plain_logits, _ = prefill_with(plain_route, prefill, params, batch)
    torch.cuda.synchronize()
    err = float((logits.float() - plain_logits.float()).abs().max())
    agree = float((logits.argmax(-1) == plain_logits.argmax(-1)).float().mean())
    log(f"[prefill] last-token logits, kernel vs plain attention: max |diff| "
        f"{err:.4g} (tol {PREFILL_TOL}, max |logit| "
        f"{float(plain_logits.float().abs().max()):.4g}), argmax agreement "
        f"{agree:.3f}")
    if not err <= PREFILL_TOL:
        raise AssertionError(f"prefill kernel vs plain: {err} > {PREFILL_TOL}")
    step_ms = cuda_ms(lambda: prefill(params, batch), iters=3, warmup=1)
    log(f"[prefill] step {step_ms:.3f} ms")
    return {"launches": launches, "step_ms": step_ms, "peak_bytes": peak,
            "layer_err": layer_err}


def phase_prefill_vs_decode():
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("smollm-360m"), dtype="float32")
    params = smoke_params(cfg, 1)
    B, S = 2, 32
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S))).cuda()
    before = flash_attention_fwd.launches
    logits_p, _ = M.make_prefill_step(cfg)(params, {"tokens": toks})
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches - before == cfg.num_layers
    decode = M.make_decode_step(cfg)
    cache = T.init_cache(cfg, B, S, "float32", device="cuda")
    for t in range(S):
        lg, cache = decode(params, toks[:, t:t + 1], cache, t)
    torch.cuda.synchronize()
    err, ok = max_excess(lg, logits_p, 0.1)    # tests/test_models_smoke.py
    same = bool((lg.argmax(-1) == logits_p.argmax(-1)).all())
    log(f"[decode] f32 B={B} S={S}: prefill (kernel) vs token-by-token decode "
        f"max |diff| {err:.3g}, argmax equal {same}")
    if not (ok and same and torch.isfinite(lg).all()):
        raise AssertionError("prefill and decode disagree at full width")


def phase_serve():
    from repro_torch.launch import serve
    argv = ["--arch", "smollm-360m", "--requests", "8", "--batch-slots", "4",
            "--max-new", "16"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outputs = serve.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if len(outputs) != 8 or not all(len(v) >= 1 for v in outputs.values()):
        raise AssertionError(f"serve answered {outputs}")
    generated = sum(len(v) for v in outputs.values())
    log(f"[serve] 8/8 requests answered, {generated} tokens generated in "
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


def main():
    card = phase_environment()
    phase_build()
    err = phase_kernel_vs_plain()
    prefill = phase_prefill()
    phase_prefill_vs_decode()
    serve_tok_s = phase_serve()
    t = phase_timings(card)
    log(f"[timing] {card}: prefill step {prefill['step_ms']:.3f} ms "
        f"(B={PREFILL_B}, S={PREFILL_S}), serve {serve_tok_s:.1f} generated "
        f"tok/s, peak memory in prefill "
        f"{prefill['peak_bytes'] / 2**30:.3f} GiB")
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:114",
        "launches": prefill["launches"],
        "max_abs_err": max(err, prefill["layer_err"]),
        "max_err_vs_plain": max(err, prefill["layer_err"]), "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"]}]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
