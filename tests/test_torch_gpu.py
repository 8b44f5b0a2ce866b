"""The port's CUDA kernels against their plain versions, on a card.

Marked ``gpu``: each test decides inside itself whether a card exists and
skips without one.  This file imports no JAX, so it runs where only the
port's dependencies are installed:
  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
Tolerances are those of tests/test_kernels.py: f32 3e-5, bf16 3e-2.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                 flash_attention_plain)

TOL = {torch.float32: 3e-5, torch.bfloat16: 3e-2}
SHAPES = [
    (1, 32, 2, 2, 16),
    (2, 64, 4, 2, 32),
    (1, 100, 8, 8, 64),      # ragged seq
    (2, 96, 6, 3, 16),
    (1, 128, 16, 4, 64),     # deep GQA
    (2, 200, 15, 5, 64),     # smollm-360m's heads, several kv tiles
    (1, 70, 4, 2, 128),
]
WINDOW_CAP = [(0, 0.0), (13, 0.0), (0, 30.0), (13, 30.0)]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _qkv(B, S, Hq, Hkv, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to("cuda", dtype)
                 for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))


@pytest.mark.gpu
def test_flash_kernel_matches_plain_on_cuda():
    _cuda()
    for shape in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _qkv(*shape, dtype)
            for window, cap in WINDOW_CAP:
                before = flash_attention_fwd.launches
                got = ops.flash_attention(q, k, v, causal=True, window=window,
                                          attn_softcap=cap)
                torch.cuda.synchronize()
                assert flash_attention_fwd.launches == before + 1
                assert got.dtype == dtype and got.shape == q.shape
                want = flash_attention_plain(q, k, v, causal=True,
                                             window=window, attn_softcap=cap)
                np.testing.assert_allclose(
                    got.float().cpu().numpy(), want.float().cpu().numpy(),
                    atol=TOL[dtype], rtol=TOL[dtype],
                    err_msg=f"{shape} {dtype} window={window} cap={cap}")
