"""The port's CUDA kernels against their plain versions, on a card.

Marked ``gpu``: each test decides inside itself whether a card exists and
skips without one.  This file imports no JAX, so it runs where only the
port's dependencies are installed:
  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
Tolerances are those of tests/test_kernels.py: flash attention f32 3e-5,
bf16 3e-2; the SSD chunk terms 5e-4 (both routes compute in f32).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                 flash_attention_plain)
from repro_torch.kernels.ref import ssd_sequential
from repro_torch.kernels.ssd import ssd_chunk_kernel, ssd_chunk_plain

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


# the bf16 tensor-core path: ragged q tiles, a window that starts inside a
# kv tile, the head dims at the ends of HEAD_DIMS with the cap, GQA ratios
FLASH_BF16_CASES = [     # (B, S, Hq, Hkv, D), window, cap
    ((1, 100, 4, 2, 64), 0, 0.0),
    ((2, 200, 6, 2, 64), 0, 0.0),
    ((1, 1000, 6, 2, 64), 0, 0.0),
    ((1, 300, 4, 4, 64), 100, 0.0),
    ((2, 260, 3, 1, 32), 77, 30.0),
    ((1, 150, 2, 1, 16), 0, 30.0),
    ((1, 190, 8, 2, 128), 0, 30.0),
    ((1, 129, 12, 4, 128), 50, 0.0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,window,cap", FLASH_BF16_CASES)
def test_flash_bf16_tensor_core_cases_on_cuda(shape, window, cap):
    _cuda()
    q, k, v = _qkv(*shape, torch.bfloat16, seed=3)
    before = flash_attention_fwd.launches
    got = ops.flash_attention(q, k, v, causal=True, window=window,
                              attn_softcap=cap)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=True, window=window,
                                 attn_softcap=cap)
    np.testing.assert_allclose(
        got.float().cpu().numpy(), want.float().cpu().numpy(),
        atol=TOL[torch.bfloat16], rtol=TOL[torch.bfloat16],
        err_msg=f"{shape} window={window} cap={cap}")


SSD_SHAPES = [            # (B, S, H, P, N, chunk): tests/test_kernels.py grid
    (1, 32, 2, 8, 4, 8),
    (2, 64, 4, 16, 8, 16),
    (1, 128, 2, 32, 16, 32),
    (2, 48, 3, 8, 8, 16),
    (1, 320, 3, 64, 128, 160),   # mamba2's P and N, ragged 64-row tiles
    (1, 512, 2, 128, 128, 256),  # jamba's P
]
SSD_TOL = 5e-4


def _ssd_inputs(B, S, H, P, N, dtype, seed=0):
    """x, B_, C_ as split views of one (B, S, H*P + 2N) tensor, as the
    model hands them to the kernel, at the model's scale (silu of a unit
    normal); dt and A f32 as the model's init makes them (A_log and dt_bias
    uniform in [0.5, 1.5)).  With unit-normal x, B, C and N = 128 a long
    chunk is too ill-conditioned for 5e-4 in f32 on either route
    (tools/ssd_conditioning.py)."""
    rng = np.random.default_rng(seed)
    normal = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    uniform = lambda *s: torch.from_numpy(rng.uniform(0.5, 1.5, s).astype(np.float32))
    xbc = torch.nn.functional.silu(normal(B, S, H * P + 2 * N)).to("cuda", dtype)
    xs, B_, C_ = torch.split(xbc, [H * P, N, N], dim=-1)
    dt = torch.nn.functional.softplus(normal(B, S, H) + uniform(H)).cuda()
    A = -torch.exp(uniform(H)).cuda()
    return xs.reshape(B, S, H, P), dt, A, B_, C_


@pytest.mark.gpu
def test_ssd_chunk_kernel_matches_plain_on_cuda():
    _cuda()
    for B, S, H, P, N, chunk in SSD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            args = _ssd_inputs(B, S, H, P, N, dtype)
            before = ssd_chunk_kernel.launches
            got = ops.ssd_chunk(*args, chunk=chunk)
            torch.cuda.synchronize()
            assert ssd_chunk_kernel.launches == before + 1
            want = ssd_chunk_plain(*args, chunk=chunk)
            for name, g, w in zip(("y_intra", "states", "decay_all",
                                   "decay_chunk"), got, want):
                assert g.dtype == torch.float32 and g.shape == w.shape
                assert bool(torch.isfinite(g).all()), name
                np.testing.assert_allclose(
                    g.cpu().numpy(), w.cpu().numpy(), atol=SSD_TOL,
                    rtol=SSD_TOL, err_msg=f"{name} {(B, S, H, P, N, chunk)} {dtype}")


def _relaid(args, layout):
    """x, B_, C_ of ``_ssd_inputs`` as separate contiguous tensors, or as
    split views of a wider tensor that start one element in, so that
    neither the base nor the row stride allows 16-byte copies."""
    x, dt, A, B_, C_ = args
    if layout == "contiguous":
        return x.contiguous(), dt, A, B_.contiguous(), C_.contiguous()
    if layout == "unaligned":
        Bsz, S, H, P = x.shape
        N = B_.shape[-1]
        wide = torch.zeros((Bsz, S, H * P + 2 * N + 1), dtype=x.dtype,
                           device=x.device)
        xs, Bs, Cs = torch.split(wide[..., 1:], [H * P, N, N], dim=-1)
        xs.copy_(x.reshape(Bsz, S, H * P))
        Bs.copy_(B_)
        Cs.copy_(C_)
        return xs.view(Bsz, S, H, P), dt, A, Bs, Cs
    return args


# the bf16 tensor-core path: head counts that the head group does not
# divide, N and P to pad, ragged 64-row tiles, a chunk longer than the
# C B^T band (512 > 256 columns), and the three layouts of x, B and C
SSD_BF16_CASES = [       # (B, S, H, P, N, chunk), layout
    ((1, 64, 3, 8, 4, 32), "split"),
    ((2, 128, 5, 16, 8, 64), "split"),
    ((1, 320, 5, 64, 128, 160), "split"),
    ((1, 256, 3, 8, 128, 256), "contiguous"),
    ((1, 512, 2, 128, 128, 256), "contiguous"),
    ((2, 320, 5, 64, 8, 160), "unaligned"),
    ((1, 256, 3, 128, 4, 256), "unaligned"),
    ((1, 1024, 2, 64, 128, 512), "split"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,layout", SSD_BF16_CASES)
def test_ssd_bf16_tensor_core_cases_on_cuda(shape, layout):
    _cuda()
    B, S, H, P, N, chunk = shape
    args = _relaid(_ssd_inputs(B, S, H, P, N, torch.bfloat16, seed=4), layout)
    before = ssd_chunk_kernel.launches
    got = ops.ssd_chunk(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_chunk_kernel.launches == before + 1
    want = ssd_chunk_plain(*args, chunk=chunk)
    for name, g, w in zip(("y_intra", "states", "decay_all", "decay_chunk"),
                          got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(
            g.cpu().numpy(), w.cpu().numpy(), atol=SSD_TOL, rtol=SSD_TOL,
            err_msg=f"{name} {shape} {layout}")


@pytest.mark.gpu
def test_ssd_through_the_kernel_matches_sequential_on_cuda():
    _cuda()
    B, S, H, P, N, chunk = 2, 64, 4, 16, 8, 16
    x, dt, A, B_, C_ = _ssd_inputs(B, S, H, P, N, torch.float32, seed=1)
    h0 = torch.randn((B, H, P, N), generator=torch.Generator().manual_seed(2)).cuda()
    y, h = ops.ssd(x, dt, A, B_, C_, chunk, h0=h0)
    sy, sh = ssd_sequential(x, dt, A, B_, C_, h0=h0)
    for got, want in ((y, sy), (h, sh)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=SSD_TOL, rtol=SSD_TOL)


@pytest.mark.gpu
def test_ssd_chunk_kernel_refuses_what_it_does_not_take():
    _cuda()
    x, dt, A, B_, C_ = _ssd_inputs(1, 32, 2, 8, 4, torch.float32)
    with pytest.raises(ValueError, match="not divisible"):
        ssd_chunk_kernel(x, dt, A, B_, C_, chunk=12)
    with pytest.raises(ValueError, match="float32"):
        ssd_chunk_kernel(x, dt.double(), A, B_, C_, chunk=8)
    with pytest.raises(ValueError, match="strides"):
        ssd_chunk_kernel(x.transpose(2, 3).contiguous().transpose(2, 3),
                         dt, A, B_, C_, chunk=8)
