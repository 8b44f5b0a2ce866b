#!/usr/bin/env python3
"""How far a rounding-level change in the SSD moves mamba2-1.3b's logits.

Runs the port's mamba2-1.3b prefill at full width on a CUDA card twice per
case, once through the SSD chunk kernel and once through its plain version
(both compute the chunk terms in f32 and differ at the level of f32
rounding), and prints the largest change in the last-token logits beside
the largest logit and the share of equal argmaxes.  Each case starts from
``init_params`` with one group of weights rescaled:
  - "init": the reference's init as it is;
  - "in_proj/2": all of in_proj halved (x, B, C, z and dt pre-activations);
  - "BC/2": only the B and C columns of in_proj halved (C.B quartered);
  - "out_proj/2": out_proj halved;
  - "dt_bias-3": dt_bias lowered by 3 (dt about 0.1 instead of about 1.3).
Usage (needs a CUDA card):
  PYTHONPATH=src python tools/mamba_sensitivity.py
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.ssd import ssd_chunk_plain
from repro_torch.models import model as M
from repro_torch.models import transformer as T


BATCH, SEQ = 8, 1024            # chip_smoke.py's prefill shape


def _bc_columns(cfg):
    inner, N = cfg.inner_dim, cfg.ssm_state
    return slice(2 * inner, 2 * inner + 2 * N)      # z | x | B C | dt


CASES = {
    "init": lambda cfg, m: None,
    "in_proj/2": lambda cfg, m: m["in_proj"].mul_(0.5),
    "BC/2": lambda cfg, m: m["in_proj"][:, _bc_columns(cfg)].mul_(0.5),
    "out_proj/2": lambda cfg, m: m["out_proj"].mul_(0.5),
    "dt_bias-3": lambda cfg, m: m["dt_bias"].sub_(3.0),
}


def prefill_both(cfg, params, batch):
    """Last-token logits through the kernel and through the plain SSD."""
    prefill = M.make_prefill_step(cfg)
    kernel, _ = prefill(params, batch)
    kernel_route = ops.ssd_chunk
    ops.ssd_chunk = ssd_chunk_plain
    try:
        plain, _ = prefill(params, batch)
    finally:
        ops.ssd_chunk = kernel_route
    return kernel.float(), plain.float()


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    base = get_config("mamba2-1.3b")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, base.vocab_size, (BATCH, SEQ))).cuda()
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(base, dtype=dtype)
        for name, rescale in CASES.items():
            params = T.init_params(cfg, 0, device="cuda")
            for layer in params["layers"]:
                rescale(cfg, layer["mixer"])
            kernel, plain = prefill_both(cfg, params, {"tokens": toks})
            print(json.dumps({
                "dtype": dtype, "case": name,
                "max_abs_diff": float((kernel - plain).abs().max()),
                "max_abs_logit": float(plain.abs().max()),
                "argmax_agreement": float(
                    (kernel.argmax(-1) == plain.argmax(-1)).float().mean())}),
                flush=True)
            del params
            torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "batch": BATCH, "seq": SEQ}))


if __name__ == "__main__":
    main()
