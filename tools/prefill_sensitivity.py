#!/usr/bin/env python3
"""How far a rounding-level change in attention moves the prefill logits.

Runs the port's smollm-360m prefill at full width on the CPU (small batch
and sequence) twice per case, once with the plain attention and once with a
perturbed one, and prints the largest change in the last-token logits
beside the largest logit:
  - float32 model, attention computed in float64 then rounded to float32;
  - bfloat16 model, attention with the CUDA kernel's rounding (p kept in
    float32 in p.v) instead of the plain version's (p rounded to bf16).
Each case runs with the reference's init (fan_in of wq/wk/wv = the head
count) and with wq/wk/wv rescaled to fan_in = d_model, as chip_smoke.py
does.  Usage:
  PYTHONPATH=src python tools/prefill_sensitivity.py [--batch 2] [--seq 128]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_reference
from repro_torch.models import model as M
from repro_torch.models import transformer as T


def _f64(q, k, v, **kw):
    return attention_reference(q.double(), k.double(), v.double(),
                               causal=kw["causal"], window=kw["window"],
                               attn_softcap=kw["attn_softcap"]).to(q.dtype)


def _kernel_rounding(q, k, v, **kw):
    return attention_reference(q.float(), k.float(), v.float(),
                               causal=kw["causal"], window=kw["window"],
                               attn_softcap=kw["attn_softcap"]).to(q.dtype)


def _case(dtype, perturbed, rescale, batch, seq):
    cfg = dataclasses.replace(get_config("smollm-360m"), dtype=dtype)
    params = T.init_params(cfg, 0, device="cpu")
    if rescale:
        for layer in params["layers"]:
            for name in ("wq", "wk", "wv"):
                w = layer["mixer"][name]
                w.mul_((w.shape[-2] / w.shape[0]) ** 0.5)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (batch, seq)))
    prefill = M.make_prefill_step(cfg)
    a, _ = prefill(params, {"tokens": toks})
    plain = ops.flash_attention
    ops.flash_attention = perturbed
    try:
        b, _ = prefill(params, {"tokens": toks})
    finally:
        ops.flash_attention = plain
    a, b = a.float(), b.float()
    print(f"{dtype:9s} {'fan_in=d_model' if rescale else 'reference init':15s}"
          f" max|dlogit| {float((a - b).abs().max()):.3g}"
          f"  max|logit| {float(a.abs().max()):.3g}"
          f"  argmax equal {bool((a.argmax(-1) == b.argmax(-1)).all())}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    args = ap.parse_args(argv)
    for rescale in (False, True):
        _case("float32", _f64, rescale, args.batch, args.seq)
        _case("bfloat16", _kernel_rounding, rescale, args.batch, args.seq)


if __name__ == "__main__":
    main()
