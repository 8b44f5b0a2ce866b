#!/usr/bin/env python3
"""Where a kernel's time goes: time variants of its source with one part
changed, at the main path's shape, on a CUDA card.

Each variant is the kernel's source with one or a few text substitutions
(a part switched off, or a tuning constant changed).  A case is a source at
one shape: the main path's, and for K1 and K1b also gemma2-9b's head dim
256 (B=1, S=8192, Hq=16, Hkv=8, cap 50, no window: a global layer), where
the wgmma kernels of that head dim run.  There each K1 variant also
gives chip_smoke's K1 gates (``fwd_readings``: o's normwise error, lse's
largest error, whether TOL alone and all the gates pass), so that the
controls that drop kv tiles show what each gate catches.  Each line also gives
the device time of each CUDA kernel the call launched, from
``torch.profiler`` (a call of K1b is three: the delta pass, dk/dv, dq).  All are built at once with
the flags of ``repro_torch.kernels._build`` under build/kernel_variants/,
bound in place of the wrapper's library, and timed with CUDA events in
turns with the unchanged source, twice over; each prints its largest
|variant - plain| beside its time, so a variant that changes the result
shows it.  Usage (needs a CUDA card), all cases or the named ones:
  PYTHONPATH=src python tools/kernel_variants.py [flash_attention_fwd]
      [ssd_chunk] [flash_attention_bwd] [ssd_chunk_bwd]
      [flash_attention_fwd_d256] [flash_attention_bwd_d256]
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs                                  # noqa: E402
from repro_torch.kernels import _build                   # noqa: E402
from repro_torch.kernels import flash_attention, ssd     # noqa: E402

OUT = _build.BUILD_DIR.parent / "kernel_variants"

# case -> {variant: substitution or list of substitutions}; a
# substitution is (old text, new text), or (old, new, count) to replace
# only the first `count` places; "base" is the source as it is
VARIANTS = {
    "flash_attention_fwd_d256": {
        "masks on every tile": (
            "if (edge_tile(qw0 + q_off, k0, Skv, causal, window))\n        fwd_scores",
            "if (true)\n        fwd_scores"),
        # change the result: by how much is the max |variant - plain|
        "tanhf for the cap": (
            "        float x = CAP ? c2 * hopper::tanh_ex2(s[e] * c1) : s[e] * c1;",
            "        float x = CAP ? c2 * tanhf(s[e] * c1) : s[e] * c1;"),
        "tanh.approx for the cap": (
            "        float x = CAP ? c2 * hopper::tanh_ex2(s[e] * c1) : s[e] * c1;",
            "        float x = s[e] * c1;\n"
            "        if (CAP) { asm(\"tanh.approx.f32 %0, %0;\" : \"+f\"(x)); x *= c2; }"),
        # wrong results: what a part costs in the call
        "no O += P V": (
            "        hopper::wgmma_rs<D, 1>(acc, pa[kk], hopper::desc_mnmajor(Vt, kk), 1);",
            "        if (D < 0) hopper::wgmma_rs<D, 1>(acc, pa[kk], hopper::desc_mnmajor(Vt, kk), 1);"),
        # controls for chip_smoke's K1 gates: rows skip kv tiles that a
        # stage refilled out of turn would lose.  Every 4th tile past the
        # 32nd (the last row loses 19% of its keys, rows before the 2048th
        # none); tile 96 alone (keys 6144-6207); tile 120 alone (keys
        # 7680-7743, under 1% of a row's keys)
        "wrong: drops every 4th kv tile past the 32nd": (
            "    if (rows) {", "    if (rows && (i < 32 || i % 4 != 3)) {"),
        "wrong: drops kv tile 96": ("    if (rows) {", "    if (rows && i != 96) {"),
        "wrong: drops kv tile 120": ("    if (rows) {", "    if (rows && i != 120) {"),
    },
    "flash_attention_bwd_d256": {
        "dk/dv masks on every tile": (
            "if (edge_tile(q0 + q_off, k0, Skv, causal, window))\n        dkdv_p_terms",
            "if (true)\n        dkdv_p_terms"),
        "dq masks on every tile": (
            "if (edge_tile(qw0 + q_off, k0, Skv, causal, window))\n        dq_p_terms",
            "if (true)\n        dq_p_terms"),
        # changes the result: by how much is the max |variant - plain|
        "tanhf for the cap": (
            "    const float th = hopper::tanh_ex2(s * c1);",
            "    const float th = tanhf(s * c1);"),
        # wrong results: what warpgroup 1's wait for p costs, and each
        # pass's last product
        "dk/dv without the exchange's barriers": [
            ("if (i > 0) hopper::named_bar_sync(XCH_EMPTY, 256);", ""),
            ("hopper::named_bar_arrive(XCH_FULL, 256);", ""),
            ("hopper::named_bar_sync(XCH_FULL, 256);", ""),
            ("if (i + 1 < iters) hopper::named_bar_arrive(XCH_EMPTY, 256);", "")],
        "no dV += P^T dO, dK += dS^T Q": (
            "      hopper::wgmma_rs<D, 1>(acc, pa[kk], hopper::desc_mnmajor(Bt, kk), 1);",
            "      if (D < 0) hopper::wgmma_rs<D, 1>(acc, pa[kk], hopper::desc_mnmajor(Bt, kk), 1);"),
        "no dQ += dS K at D = 256": (
            "        hopper::wgmma_rs<D, 1>(dqa, sa[kk], hopper::desc_mnmajor(Kt, kk), 1);",
            "        if (D < 0) hopper::wgmma_rs<D, 1>(dqa, sa[kk], hopper::desc_mnmajor(Kt, kk), 1);"),
    },
    "ssd_chunk": {
        "no state blocks": (
            "  // ---- the state's columns nb .. nb+63",
            "  if (a.G > 0) return;\n  // ---- the state's columns nb .. nb+63"),
        "no y blocks": (
            "  if (role >= a.n_st) {\n",
            "  if (role >= a.n_st) {\n    if (a.G > 0) return;\n"),
        "two-part split": ("for (int u = 0; u < 3; ++u)",
                           "for (int u = 0; u < 2; ++u)"),
        "heads per block for 2 blocks per SM": (
            "blocks_for(a.G) < 8LL * sms", "blocks_for(a.G) < 2LL * sms"),
        "heads per block for 16 blocks per SM": (
            "blocks_for(a.G) < 8LL * sms", "blocks_for(a.G) < 16LL * sms"),
    },
    "flash_attention_fwd": {
        "masks on every tile": ("    if (edge) {", "    if (true) {"),
    },
    "ssd_chunk_bwd": {
        "per-head kernel with up to 255 registers (2 blocks per SM)": (
            "__global__ void __launch_bounds__(MT) ssd_bwd_chunk_mma_kernel",
            "__global__ void __launch_bounds__(MT, 2) ssd_bwd_chunk_mma_kernel"),
        "head sums in one group of heads": ("constexpr int HG = 2;", "constexpr int HG = 1;"),
        # wrong results: what a part costs in the call
        "head sums without the loads of heads ahead": (
            "    if (h + HSTAGES - 1 < nh) issue(h + HSTAGES - 1);",
            "    if (h + HSTAGES - 1 < 2) issue(h + HSTAGES - 1);"),
    },
    "flash_attention_bwd": {
        "dk/dv pass with masks on every tile": (
            "if (edge_tile(q0 + q_off, k0, Skv, causal, window))", "if (true)", 1),
        # the streamed stages' loads off (the stage completes at once, on
        # stale shared memory): what streaming costs each pass
        "dk/dv pass without its Q, dO, lse, delta loads": [
            ("hopper::mbar_expect_tx(&full[s], 2 * L::TILE + 2 * BQ * 4);\n"
             "        for (int p = 0; p < NP; ++p) {",
             "hopper::mbar_expect_tx(&full[s], 0);\n"
             "        if (D < 0) for (int p = 0; p < NP; ++p) {"),
            ("        hopper::bulk_load(st + 2 * L::TILE, lse2 + row, BQ * 4, &full[s]);\n"
             "        hopper::bulk_load(st + 2 * L::TILE + BQ * 4, delta + row, BQ * 4, &full[s]);",
             "")],
        "dq pass without its K, V loads": (
            "hopper::mbar_expect_tx(&full[s], 2 * L::TILE);\n"
            "        for (int p = 0; p < NP; ++p) {",
            "hopper::mbar_expect_tx(&full[s], 0);\n"
            "        if (D < 0) for (int p = 0; p < NP; ++p) {"),
        "a branch on the cap at every entry": (
            "  if (CAP) {\n    const float th", "  if (c2 != 0.f) {\n    const float th"),
        "dk/dv 3 blocks per SM (at most 136 registers)": (
            "__launch_bounds__(WG_THREADS, D == 64 ? 2 : 1)\nflash_bwd_dkdv",
            "__launch_bounds__(WG_THREADS, D == 64 ? 3 : 1)\nflash_bwd_dkdv"),
        "dq 2 blocks per SM": (
            "__launch_bounds__(WG_THREADS, D == 64 ? 3 : 1)\nflash_bwd_dq",
            "__launch_bounds__(WG_THREADS, D == 64 ? 2 : 1)\nflash_bwd_dq"),
        "2 stages": ("constexpr int STAGES = D == 64 ? 3 : 2;",
                     "constexpr int STAGES = D == 64 ? 2 : 2;"),
        "4 stages": ("constexpr int STAGES = D == 64 ? 3 : 2;",
                     "constexpr int STAGES = D == 64 ? 4 : 2;"),
    },
}


def build(name, source, variants):
    """Compile every variant of csrc/<source>.cu for case ``name``;
    returns variant -> .so."""
    OUT.mkdir(parents=True, exist_ok=True)
    for h in _build.CSRC.glob("*.cuh"):
        (OUT / h.name).write_text(h.read_text())
    src = (_build.CSRC / f"{source}.cu").read_text()
    texts = {}
    for variant, subs in {"base": [], **variants}.items():
        text = src
        for sub in [subs] if isinstance(subs, tuple) else subs:
            old, new, count = (*sub, -1) if len(sub) == 2 else sub
            if text.count(old) < 1:
                raise RuntimeError(f"{name}: {variant!r} does not match the source")
            text = text.replace(old, new, count)
        texts[variant] = text
    procs, libs = {}, {}
    for i, (variant, text) in enumerate(texts.items()):
        cu, so = OUT / f"{name}_{i}.cu", OUT / f"{name}_{i}.so"
        cu.write_text(text)
        procs[variant] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        libs[variant] = so
    for variant, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} {variant!r}:\n{log}")
    return libs


def bind(module, symbol, argtypes, so):
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    if symbol == "ssd_chunk_bwd":
        lib.ssd_chunk_bwd_workspace.argtypes = [ctypes.c_int] * 7
        lib.ssd_chunk_bwd_workspace.restype = ctypes.c_longlong
    setattr(module, "_bind_bwd" if symbol.endswith("_bwd") else "_bind",
            lambda: (lib, fn))


def device_us(run, calls=10):
    """Device time per call of each CUDA kernel that ``run`` launches."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if t and "CUDA" in str(getattr(e, "device_type", "")):
            name = re.search(r"\w+_kernel(<[^>]*>)?", e.key)
            out[name.group(0) if name else e.key[:70]] = t / calls
    return out


def main():
    card = cs.phase_environment()
    q, k, v = cs.qkv((cs.PREFILL_B, cs.PREFILL_S, 15, 5, 64), torch.bfloat16, seed=1)
    ssd_args = cs.ssd_inputs(cs.MAMBA_SHAPE, torch.bfloat16, seed=3)
    tq, tk, tv = cs.qkv(cs.TRAIN_SHAPE, torch.bfloat16, seed=7)
    tdo = cs.qkv(cs.TRAIN_SHAPE, torch.bfloat16, seed=8)[0]
    to, tlse = flash_attention.flash_attention_fwd(tq, tk, tv, causal=True,
                                                   with_lse=True)
    bwd = (tq, tk, tv, to, tlse, tdo)
    ssd_cts = cs.ssd_cotangents(cs.MAMBA_SHAPE, seed=4)
    gq, gk, gv = cs.qkv(cs.GEMMA_SHAPE, torch.bfloat16, seed=17)
    gdo = cs.qkv(cs.GEMMA_SHAPE, torch.bfloat16, seed=18)[0]
    gkw = dict(causal=True, attn_softcap=cs.GEMMA_CAP)
    go, glse = flash_attention.flash_attention_fwd(gq, gk, gv, with_lse=True,
                                                   **gkw)
    gbwd = (gq, gk, gv, go, glse, gdo)

    def k1_gates(want):
        o, lse = flash_attention.flash_attention_fwd(gq, gk, gv, with_lse=True,
                                                     **gkw)
        return cs.fwd_readings(o, want[0], lse, want[1])
    fwd_args = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    bwd_args = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    # case -> (source, module, symbol, argtypes, run, plain[, gates]):
    # gates(plain's result) -> readings, where plain is not run's own
    cases = {
        "flash_attention_fwd": (
            "flash_attention_fwd", flash_attention, "flash_attention_fwd", fwd_args,
            lambda: flash_attention.flash_attention_fwd(q, k, v, causal=True),
            lambda: flash_attention.flash_attention_plain(q, k, v, causal=True)),
        "flash_attention_fwd_d256": (
            "flash_attention_fwd", flash_attention, "flash_attention_fwd", fwd_args,
            lambda: flash_attention.flash_attention_fwd(gq, gk, gv, **gkw),
            lambda: flash_attention.flash_attention_lse_plain(gq, gk, gv, **gkw),
            k1_gates),
        "ssd_chunk": (
            "ssd_chunk", ssd, "ssd_chunk",
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 6
            + [ctypes.c_void_p],
            lambda: ssd.ssd_chunk_kernel(*ssd_args, chunk=cs.MAMBA_SHAPE[-1]),
            lambda: ssd.ssd_chunk_plain(*ssd_args, chunk=cs.MAMBA_SHAPE[-1])),
        "flash_attention_bwd": (
            "flash_attention_bwd", flash_attention, "flash_attention_bwd", bwd_args,
            lambda: flash_attention.flash_attention_bwd(*bwd, causal=True),
            lambda: flash_attention.flash_attention_bwd_plain(*bwd, causal=True)),
        "flash_attention_bwd_d256": (
            "flash_attention_bwd", flash_attention, "flash_attention_bwd", bwd_args,
            lambda: flash_attention.flash_attention_bwd(*gbwd, **gkw),
            lambda: flash_attention.flash_attention_bwd_plain(*gbwd, **gkw)),
        "ssd_chunk_bwd": (
            "ssd_chunk_bwd", ssd, "ssd_chunk_bwd",
            [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7
            + [ctypes.c_longlong] * 6 + [ctypes.c_void_p],
            lambda: ssd.ssd_chunk_bwd_kernel(*ssd_args, *ssd_cts,
                                             chunk=cs.MAMBA_SHAPE[-1]),
            lambda: ssd.ssd_chunk_bwd_plain(*ssd_args, *ssd_cts,
                                            chunk=cs.MAMBA_SHAPE[-1])),
    }
    only = sys.argv[1:] or list(cases)
    for name, (source, module, symbol, argtypes, run, plain,
               *gates) in cases.items():
        if name not in only:
            continue
        libs = build(name, source, VARIANTS[name])
        want = plain()
        order = list(libs)
        for rep in range(2):
            for variant in order if rep == 0 else order[::-1]:
                bind(module, symbol, argtypes, libs[variant])
                ms = cs.cuda_ms(run, iters=20)
                got = run()
                got = got if torch.is_tensor(got) else got[0]
                ref = want if torch.is_tensor(want) else want[0]
                print(json.dumps({
                    "card": card, "kernel": name, "variant": variant, "rep": rep,
                    "ms": ms, "max_abs_vs_plain": float((got.float() - ref.float()).abs().max()),
                    **({"gates": gates[0](want)} if gates else {}),
                    "device_us": device_us(run)}),
                    flush=True)


if __name__ == "__main__":
    main()
