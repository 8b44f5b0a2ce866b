#!/usr/bin/env python3
"""Where a kernel's time goes: time variants of its source with one part
changed, at the main path's shape, on a CUDA card.

Each variant is the kernel's source with one or a few text substitutions
(a part switched off, or a tuning constant changed).  A case is a source at
one shape: the main path's (smollm-360m's, D=64), for K1 also
internvl2-76b's D=128 (B=4, S=2048, Hq=64, Hkv=8), and for K1 and K1b
gemma2-9b's head dim 256 (B=1, S=8192, Hq=16, Hkv=8, cap 50, no window: a
global layer).  At head dim 256 each K1 variant also gives chip_smoke's
K1 gates (``fwd_readings``: o's normwise error, lse's
largest error, whether TOL alone and all the gates pass), so that the
controls that drop kv tiles show what each gate catches.  Each line also gives
the device time of each CUDA kernel the call launched, from
``torch.profiler`` (a call of K1b is three: the delta pass, dk/dv, dq),
and in its first turn ptxas's registers, spills and wgmma serializations
for each kernel of the variant's library.  All are built at once with
the flags of ``repro_torch.kernels._build`` under build/kernel_variants/,
bound in place of the wrapper's library, and timed with CUDA events in
turns with the unchanged source, twice over; each prints its largest
|variant - plain| beside its time, so a variant that changes the result
shows it.  Usage (needs a CUDA card), all cases or the named ones:
  PYTHONPATH=src python tools/kernel_variants.py [flash_attention_fwd]
      [ssd_chunk] [flash_attention_bwd] [ssd_chunk_bwd]
      [flash_attention_fwd_d128] [flash_attention_fwd_d256]
      [flash_attention_bwd_d256]
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
VLM_ATTN = (4, 2048, 64, 8, 128)   # internvl2-76b's attention: B=4, 1024 patches + 1024 tokens

# case -> {variant: substitution or list of substitutions}; a
# substitution is (old text, new text), or (old, new, count) to replace
# only the first `count` places; "base" is the source as it is
# K1's wgmma kernel at D = 64, 128 (and 256): the design's choices, each
# against the one taken
FWD_DESIGN = {
    "masks on every tile": (
        "if (edge_tile<BN>(qw0 + q_off, k0, Skv, causal, window))", "if (true)"),
    "no overlap: P V waited for before the softmax": (
        "hopper::wgmma_wait<1>();         // S of tile i has landed",
        "hopper::wgmma_wait<0>();"),
    "no ping-pong: the warpgroups issue when ready": [
        ("  auto my_turn = [&] { hopper::named_bar_sync(1 + wg, 256); };",
         "  auto my_turn = [&] {};"),
        ("    if (!last || wg == 0) hopper::named_bar_arrive(2 - wg, 256);", "    (void)last;"),
        ("    if (wg == 1) hopper::named_bar_arrive(1, 256);   // warpgroup 0 first\n", "")],
    "two blocks an SM asked of ptxas at D = 64": (
        "__launch_bounds__(FwdWg<D>::THREADS, 1)",
        "__launch_bounds__(FwdWg<D>::THREADS, D == 64 ? 2 : 1)"),
    "kv tiles of 128 rows at D = 64": ("static constexpr int BN = D == 128 ? 128 : 64;",
                                       "static constexpr int BN = D == 256 ? 64 : 128;"),
    "kv tiles of 64 rows at D = 128": ("static constexpr int BN = D == 128 ? 128 : 64;",
                                       "static constexpr int BN = 64;"),
    "3 stages at D = 64 and 128": ("static constexpr int STAGES = 2;",
                                   "static constexpr int STAGES = D == 256 ? 2 : 3;"),
    # the refill protocol: a producer warp (a ninth warp: at most 168
    # registers a thread) waits on an empty
    # mbarrier of each stage, which each consumer warp arrives on, and
    # issues every load
    "a producer warp refills the stages": [
        ("static constexpr int THREADS = 32 * WARPS;",
         "static constexpr int THREADS = 32 * WARPS + 32;"),
        ("static constexpr int BARS = (2 * STAGES + 1) * 8 + 2 * STAGES * 4;",
         "static constexpr int BARS = (4 * STAGES + 1) * 8;"),
        ("  uint32_t* k_done = reinterpret_cast<uint32_t*>(q_bar + 1);   // warps done, a stage\n"
         "  uint32_t* v_done = k_done + L::STAGES;",
         "  uint64_t* k_empty = q_bar + 1;\n  uint64_t* v_empty = k_empty + L::STAGES;"),
        ("      k_done[s] = v_done[s] = 0;",
         "      hopper::mbar_init(&k_empty[s], L::WARPS);\n"
         "      hopper::mbar_init(&v_empty[s], L::WARPS);"),
        ("  if (tid == 0 && n > 0) {", "  if (warp == L::WARPS) {\n  if (lane == 0 && n > 0) {"),
        ("    for (int i = 0; i < n && i < L::STAGES; ++i) {\n"
         "      issue_k(i);\n"
         "      issue_v(i);\n"
         "    }\n  }",
         "    for (int i = 0; i < n; ++i) {\n"
         "      if (i >= L::STAGES) hopper::mbar_wait(&k_empty[i % L::STAGES], (i / L::STAGES - 1) & 1);\n"
         "      issue_k(i);\n"
         "      if (i >= L::STAGES) hopper::mbar_wait(&v_empty[i % L::STAGES], (i / L::STAGES - 1) & 1);\n"
         "      issue_v(i);\n"
         "    }\n  }\n  return;\n  }"),
        ("    if (lane == 0 &&\n"
         "        hopper::count_out(&k_done[i % L::STAGES], L::WARPS * (i / L::STAGES + 1)) &&\n"
         "        i + L::STAGES < n)\n"
         "      issue_k(i + L::STAGES);",
         "    if (lane == 0) hopper::mbar_arrive(&k_empty[i % L::STAGES]);"),
        ("    if (lane == 0 &&\n"
         "        hopper::count_out(&v_done[i % L::STAGES], L::WARPS * (i / L::STAGES + 1)) &&\n"
         "        i + L::STAGES < n)\n"
         "      issue_v(i + L::STAGES);",
         "    if (lane == 0) hopper::mbar_arrive(&v_empty[i % L::STAGES]);")],
    "rescale O only where a warp's row max moved": (
        "#pragma unroll\n    for (int j = 0; j < D / 8; ++j)\n#pragma unroll\n"
        "      for (int r = 0; r < 2; ++r) {\n        acc[4 * j + 2 * r] *= corr[r];",
        "    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f))\n"
        "#pragma unroll\n    for (int j = 0; j < D / 8; ++j)\n#pragma unroll\n"
        "      for (int r = 0; r < 2; ++r) {\n        acc[4 * j + 2 * r] *= corr[r];"),
    # wrong results: what each part costs in the call
    "wrong: no S product": (
        "      hopper::wgmma_ss<BN, 0>(sc, hopper::desc_kmajor(Qw, ks),",
        "      if (D < 0) hopper::wgmma_ss<BN, 0>(sc, hopper::desc_kmajor(Qw, ks),"),
    "wrong: no softmax": ("    online_softmax(sc, CAP ? 1.f : c1, m, l, corr);",
                          "    corr[0] = corr[1] = 1.f;"),
    "wrong: no rescale of O": (
        "        acc[4 * j + 2 * r] *= corr[r];\n        acc[4 * j + 2 * r + 1] *= corr[r];",
        ""),
    "wrong: no kv loads past the first stages": (
        "    hopper::mbar_expect_tx(bar, L::TILE);",
        "    if (i >= L::STAGES) { hopper::mbar_expect_tx(bar, 0); return; }\n"
        "    hopper::mbar_expect_tx(bar, L::TILE);"),
    "no O += P V": (
        "      hopper::wgmma_rs<D, 1>(acc, pa[kk], hopper::desc_mnmajor(Vt, kk, L::PANEL), 1);",
        "      if (D < 0) hopper::wgmma_rs<D, 1>(acc, pa[kk], hopper::desc_mnmajor(Vt, kk, L::PANEL), 1);"),
}


def _drop_tiles(cond):
    """A control that drops the kv tiles i (from the block's first) for
    which ``cond`` holds: their scores become -inf, so p = 0 there."""
    return ("    online_softmax(sc, CAP ? 1.f : c1, m, l, corr);",
            f"    if ({cond}) for (int e = 0; e < BN / 2; ++e) sc[e] = -INFINITY;\n"
            "    online_softmax(sc, CAP ? 1.f : c1, m, l, corr);")


VARIANTS = {
    "flash_attention_fwd": FWD_DESIGN,
    "flash_attention_fwd_d128": FWD_DESIGN,
    "flash_attention_fwd_d256": {
        "masks on every tile": FWD_DESIGN["masks on every tile"],
        "no overlap: P V waited for before the softmax":
            FWD_DESIGN["no overlap: P V waited for before the softmax"],
        "no ping-pong: the warpgroups issue when ready":
            FWD_DESIGN["no ping-pong: the warpgroups issue when ready"],
        # change the result: by how much is the max |variant - plain|
        "tanhf for the cap": (
            "s[e] = c2 * hopper::tanh_ex2(s[e] * c1);", "s[e] = c2 * tanhf(s[e] * c1);"),
        "tanh.approx for the cap": (
            "s[e] = c2 * hopper::tanh_ex2(s[e] * c1);",
            "{\n    float x = s[e] * c1;\n"
            "    asm(\"tanh.approx.f32 %0, %0;\" : \"+f\"(x));\n    s[e] = c2 * x;\n  }"),
        # wrong results: what a part costs in the call
        "no O += P V": FWD_DESIGN["no O += P V"],
        # controls for chip_smoke's K1 gates: rows drop kv tiles that a
        # stage refilled out of turn would lose.  Every 4th tile past the
        # 32nd (the last row loses 19% of its keys, rows before the 2048th
        # none); tile 96 alone (keys 6144-6207); tile 120 alone (keys
        # 7680-7743, under 1% of a row's keys)
        "wrong: drops every 4th kv tile past the 32nd": _drop_tiles("i >= 32 && i % 4 == 3"),
        "wrong: drops kv tile 96": _drop_tiles("i == 96"),
        "wrong: drops kv tile 120": _drop_tiles("i == 120"),
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
        libs[variant] = (libs[variant], ptxas_notes(log))
    return libs


def _kernel_name(mangled):
    """The unqualified name ending in ``_kernel`` inside a mangled name,
    found through its length prefix."""
    for run in re.finditer(r"\d+", mangled):
        for k in range(len(run.group())):
            n = int(run.group()[k:])
            name = mangled[run.end():run.end() + n]
            if name.endswith("_kernel") and name[:1].isalpha() and len(name) == n:
                return name
    return mangled[:40]


def ptxas_notes(log):
    """Per kernel template of an ``nvcc -Xptxas -v`` log: the registers of
    each instantiation and its spill bytes, and the count of ptxas's notes
    that it serialized wgmma instructions (C7510-C7520)."""
    out = {}
    for part in log.split("Compiling entry function '")[1:]:
        mangled = part.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        e = out.setdefault(_kernel_name(mangled),
                           {"registers": [], "spill_bytes": 0, "serialized": 0})
        e["registers"].append(int(regs.group(1)) if regs else None)
        e["spill_bytes"] += int(spill.group(1)) if spill else 0
    for line in log.splitlines():
        if "wgmma.mma_async instructions are serialized" in line:
            kernel = _kernel_name(line.split("function")[-1])
            if kernel in out:
                out[kernel]["serialized"] += 1
    return out


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
    vq, vk, vv = cs.qkv(VLM_ATTN, torch.bfloat16, seed=19)
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
    fwd_args = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    bwd_args = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    # case -> (source, module, symbol, argtypes, run, plain[, gates]):
    # gates(plain's result) -> readings, where plain is not run's own
    cases = {
        "flash_attention_fwd": (
            "flash_attention_fwd", flash_attention, "flash_attention_fwd", fwd_args,
            lambda: flash_attention.flash_attention_fwd(q, k, v, causal=True),
            lambda: flash_attention.flash_attention_plain(q, k, v, causal=True)),
        "flash_attention_fwd_d128": (
            "flash_attention_fwd", flash_attention, "flash_attention_fwd", fwd_args,
            lambda: flash_attention.flash_attention_fwd(vq, vk, vv, causal=True),
            lambda: flash_attention.flash_attention_plain(vq, vk, vv, causal=True)),
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
                so, notes = libs[variant]
                bind(module, symbol, argtypes, so)
                ms = cs.cuda_ms(run, iters=20)
                got = run()
                got = got if torch.is_tensor(got) else got[0]
                ref = want if torch.is_tensor(want) else want[0]
                print(json.dumps({
                    "card": card, "kernel": name, "variant": variant, "rep": rep,
                    "ms": ms, "max_abs_vs_plain": float((got.float() - ref.float()).abs().max()),
                    **({"gates": gates[0](want)} if gates else {}),
                    "device_us": device_us(run),
                    **({"ptxas": notes} if rep == 0 else {})}),
                    flush=True)


if __name__ == "__main__":
    main()
