#!/usr/bin/env python3
"""Where a kernel's time goes: time variants of its source with one part
changed, at the main path's shape, on a CUDA card.

Each variant is the kernel's source with one text substitution (a part
switched off, or a tuning constant changed).  All are built at once with
the flags of ``repro_torch.kernels._build`` under build/kernel_variants/,
bound in place of the wrapper's library, and timed with CUDA events in
turns with the unchanged source, twice over; each prints its largest
|variant - plain| beside its time, so a variant that changes the result
shows it.  Usage (needs a CUDA card):
  PYTHONPATH=src python tools/kernel_variants.py
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs                                  # noqa: E402
from repro_torch.kernels import _build                   # noqa: E402
from repro_torch.kernels import flash_attention, ssd     # noqa: E402

OUT = _build.BUILD_DIR.parent / "kernel_variants"

# kernel -> {variant: (old text, new text)}; "base" is the source as it is
VARIANTS = {
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
}


def build(name, variants):
    """Compile every variant of csrc/<name>.cu; returns variant -> .so."""
    OUT.mkdir(parents=True, exist_ok=True)
    for h in _build.CSRC.glob("*.cuh"):
        (OUT / h.name).write_text(h.read_text())
    src = (_build.CSRC / f"{name}.cu").read_text()
    procs, libs = {}, {}
    for i, (variant, (old, new)) in enumerate({"base": ("", ""), **variants}.items()):
        if old and src.count(old) < 1:
            raise RuntimeError(f"{name}: {variant!r} does not match the source")
        cu, so = OUT / f"{name}_{i}.cu", OUT / f"{name}_{i}.so"
        cu.write_text(src.replace(old, new) if old else src)
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
    module._bind = lambda: (lib, fn)


def main():
    card = cs.phase_environment()
    q, k, v = cs.qkv((cs.PREFILL_B, cs.PREFILL_S, 15, 5, 64), torch.bfloat16, seed=1)
    ssd_args = cs.ssd_inputs(cs.MAMBA_SHAPE, torch.bfloat16, seed=3)
    cases = {
        "flash_attention_fwd": (
            flash_attention, "flash_attention_fwd",
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2
            + [ctypes.c_void_p],
            lambda: flash_attention.flash_attention_fwd(q, k, v, causal=True),
            lambda: flash_attention.flash_attention_plain(q, k, v, causal=True)),
        "ssd_chunk": (
            ssd, "ssd_chunk",
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 6
            + [ctypes.c_void_p],
            lambda: ssd.ssd_chunk_kernel(*ssd_args, chunk=cs.MAMBA_SHAPE[-1]),
            lambda: ssd.ssd_chunk_plain(*ssd_args, chunk=cs.MAMBA_SHAPE[-1])),
    }
    for name, (module, symbol, argtypes, run, plain) in cases.items():
        libs = build(name, VARIANTS[name])
        want = plain()
        order = list(libs)
        for rep in range(2):
            for variant in order if rep == 0 else order[::-1]:
                bind(module, symbol, argtypes, libs[variant])
                ms = cs.cuda_ms(run, iters=20)
                got = run()
                got, ref = (got, want) if torch.is_tensor(got) else (got[0], want[0])
                print(json.dumps({
                    "card": card, "kernel": name, "variant": variant, "rep": rep,
                    "ms": ms, "max_abs_vs_plain": float((got.float() - ref.float()).abs().max())}),
                    flush=True)


if __name__ == "__main__":
    main()
