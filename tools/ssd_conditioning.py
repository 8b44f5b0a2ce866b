#!/usr/bin/env python3
"""How close the SSD chunk kernel and its plain version each come to a
float64 truth, at the mamba2-1.3b prefill shape on the card.

Both routes compute the intra-chunk terms in float32 from the same inputs;
the truth is ``ssd_chunk_terms`` in float64 on those inputs.  Three draws:
  - "sweep": as tests/test_kernels.py draws them: x, B, C ~ N(0,1),
    A = -exp(0.5 N(0,1)), dt = softplus(N(0,1)): slow decays, so a
    256-long chunk sums hundreds of terms of size ~10;
  - "unit": x, B, C ~ N(0,1), dt and A as the model's init makes them
    (A = -exp(A_log), dt = softplus(N(0,1) + dt_bias), A_log and dt_bias
    uniform in [0.5, 1.5));
  - "model": the same dt and A, and x, B, C = silu(N(0,1)), the scale
    they have in ``mamba_layer`` at init (the conv of a unit-variance
    projection with conv_w of fan_in 4, then silu).
For each term it prints the largest |route - truth| of each route, the
largest |kernel - plain|, and how many elements of each route miss the
truth by more than 5e-4 abs + 5e-4 rel.  Usage (needs a CUDA card):
  PYTHONPATH=src python tools/ssd_conditioning.py
"""
from __future__ import annotations

import json

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import ssd_chunk_terms
from repro_torch.kernels.ssd import ssd_chunk_kernel, ssd_chunk_plain

TERMS = ("y_intra", "states", "decay_all", "decay_chunk")
TOL = 5e-4
SHAPE, CHUNK = (8, 1024, 64, 64, 128), 256    # mamba2-1.3b prefill: B S H P N


def draw(B, S, H, P, N, dtype, kind, seed=0, device="cuda"):
    rng = np.random.default_rng(seed)
    normal = lambda *s: torch.from_numpy(rng.standard_normal(s, np.float32)).to(device)
    uniform = lambda *s: torch.from_numpy(
        rng.uniform(0.5, 1.5, s).astype(np.float32)).to(device)
    xbc = normal(B, S, H * P + 2 * N)
    if kind == "model":
        xbc = F.silu(xbc)
    xs, B_, C_ = torch.split(xbc.to(dtype), [H * P, N, N], dim=-1)
    if kind == "sweep":
        dt, A = F.softplus(normal(B, S, H)), -torch.exp(normal(H) * 0.5)
    else:
        dt, A = F.softplus(normal(B, S, H) + uniform(H)), -torch.exp(uniform(H))
    return xs.reshape(B, S, H, P), dt, A, B_, C_


def truth(x, dt, A, B_, C_, chunk):
    """``ssd_chunk_plain``'s layout, computed in float64."""
    Bsz, S, H, P = x.shape
    N, nc = B_.shape[-1], S // chunk
    y, st, dall, dch = ssd_chunk_terms(
        x.double().reshape(Bsz * nc, chunk, H, P),
        dt.double().reshape(Bsz * nc, chunk, H), A.double(),
        B_.double().reshape(Bsz * nc, chunk, N),
        C_.double().reshape(Bsz * nc, chunk, N))
    return (y.reshape(Bsz, S, H, P), st.reshape(Bsz, nc, H, P, N).transpose(1, 2),
            dall.reshape(Bsz, nc, H, chunk).transpose(1, 2),
            dch.reshape(Bsz, nc, H).transpose(1, 2))


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    for kind in ("sweep", "unit", "model"):
        for dtype in (torch.float32, torch.bfloat16):
            inputs = draw(*SHAPE, dtype, kind)
            kernel = ssd_chunk_kernel(*inputs, chunk=CHUNK)
            plain = ssd_chunk_plain(*inputs, chunk=CHUNK)
            exact = truth(*inputs, CHUNK)
            for name, k, p, t in zip(TERMS, kernel, plain, exact):
                k, p = k.double(), p.double()
                row = {"draw": kind, "dtype": str(dtype), "term": name,
                       "max_abs_truth": float(t.abs().max())}
                for route, v in (("kernel", k), ("plain", p)):
                    d = (v - t).abs()
                    row[f"{route}_max_err"] = float(d.max())
                    row[f"{route}_over_tol"] = int((d > TOL + TOL * t.abs()).sum())
                row["kernel_vs_plain"] = float((k - p).abs().max())
                print(json.dumps(row), flush=True)
            del kernel, plain, exact
            torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "shape": list(SHAPE) + [CHUNK]}))


if __name__ == "__main__":
    main()
