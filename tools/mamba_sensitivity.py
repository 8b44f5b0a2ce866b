#!/usr/bin/env python3
"""How far a rounding-level change in the SSD moves mamba2-1.3b's logits.

Runs the port's mamba2-1.3b prefill at full width on a CUDA card three
times per case: through the SSD chunk kernel, through its plain version,
and through the plain version with y_intra scaled by 1 + 2^-23 (one f32
ulp, "nudged").  It prints the largest change in the last-token logits
between kernel and plain and between plain and nudged (the change one ulp
of f32 rounding makes: the floor of any comparison of two routes), beside
the largest logit and the share of equal argmaxes.  Each case starts from
``init_params`` with one group of weights changed:
  - "init": the reference's init as it is;
  - "in_proj/2": all of in_proj halved (x, B, C, z and dt pre-activations);
  - "BC/2": only the B and C columns of in_proj halved (C.B quartered);
  - "out_proj/2": out_proj halved;
  - "dt_bias-3": dt_bias lowered by 3 (dt about 0.1 instead of about 1.3);
  - "published dt/A": dt_bias and A_log drawn as Mamba2's published init
    draws them (``mamba_ssm``: dt log-uniform in [1e-3, 0.1], A uniform in
    [1, 16]) instead of the reference's uniform [0.5, 1.5) for both.
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


def published_dt_a(params, seed):
    """Redraw every mamba layer's dt_bias and A_log, in place, as
    ``mamba_ssm`` initialises them: dt = exp(U(log 1e-3, log 0.1)), dt_bias
    its inverse softplus, A_log = log U(1, 16); from a numpy seed.  Other
    layers (a hybrid's attention) are left as they are."""
    rng = np.random.default_rng(seed)
    for layer in params["layers"]:
        m = layer["mixer"]
        if "A_log" not in m:
            continue
        H = m["A_log"].shape[0]
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), H))
        m["dt_bias"].copy_(torch.from_numpy(dt + np.log(-np.expm1(-dt))))
        m["A_log"].copy_(torch.from_numpy(np.log(rng.uniform(1, 16, H))))
    return params


CASES = {
    "init": lambda cfg, m: None,
    "in_proj/2": lambda cfg, m: m["in_proj"].mul_(0.5),
    "BC/2": lambda cfg, m: m["in_proj"][:, _bc_columns(cfg)].mul_(0.5),
    "out_proj/2": lambda cfg, m: m["out_proj"].mul_(0.5),
    "dt_bias-3": lambda cfg, m: m["dt_bias"].sub_(3.0),
    "published dt/A": None,             # published_dt_a on all layers
}


def nudged_plain(*args, **kw):
    """The plain chunk terms with y_intra one f32 ulp larger."""
    y, states, decay_all, decay_chunk = ssd_chunk_plain(*args, **kw)
    return y * (1 + 2.0 ** -23), states, decay_all, decay_chunk


def prefill_routes(cfg, params, batch):
    """Last-token logits through the kernel, the plain SSD and the nudged
    plain SSD."""
    prefill = M.make_prefill_step(cfg)
    kernel_route = ops.ssd_chunk
    out = {}
    for name, route in (("kernel", kernel_route), ("plain", ssd_chunk_plain),
                        ("nudged", nudged_plain)):
        ops.ssd_chunk = route
        try:
            out[name] = prefill(params, batch)[0].float()
        finally:
            ops.ssd_chunk = kernel_route
    return out


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    base = get_config("mamba2-1.3b")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, base.vocab_size, (BATCH, SEQ))).cuda()
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(base, dtype=dtype)
        for name, rescale in CASES.items():
            params = T.init_params(cfg, 0, device="cuda")
            if rescale is None:
                published_dt_a(params, 7)
            else:
                for layer in params["layers"]:
                    rescale(cfg, layer["mixer"])
            lg = prefill_routes(cfg, params, {"tokens": toks})
            plain = lg["plain"]
            print(json.dumps({
                "dtype": dtype, "case": name,
                "max_abs_diff": float((lg["kernel"] - plain).abs().max()),
                "plain_vs_nudged": float((lg["nudged"] - plain).abs().max()),
                "max_abs_logit": float(plain.abs().max()),
                "argmax_agreement": float(
                    (lg["kernel"].argmax(-1) == plain.argmax(-1)).float().mean())}),
                flush=True)
            del params
            torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "batch": BATCH, "seq": SEQ}))


if __name__ == "__main__":
    main()
