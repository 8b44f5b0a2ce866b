"""The rounding of the bf16 flash-attention kernel, emulated on the CPU.

``flash_fwd_mma_kernel`` and, at head dim 256, ``flash_fwd_wgmma_kernel``
(csrc/flash_attention_fwd.cu) keep bf16 inputs in bf16, sum Q K^T in f32,
run the online softmax per 64-key tile in log2 units, and round the
unnormalised p of each tile to bf16 before the P V product, which sums in
f32; the row sum l takes p before rounding.  At head dim 256 the cap's
tanh is 1 - 2 / (2^(2x log2 e) + 1), as ``hopper::tanh_ex2`` forms it.  The
plain version (``attention_reference``) normalises p first and rounds the
normalised p.  ``emulate`` does in torch what the kernel does, and is held
against the plain version at the bf16 tolerance of tests/test_kernels.py
(3e-2) over the reference's sweep grid and a few shapes of the kernel's
own edges: so the design meets the tolerance before a card is used.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import attention_reference

TOL = 3e-2
BK = 64                      # the kernel's kv tile
NEG_INF = -1e30
LOG2E = 1.4426950408889634
SHAPES = [                   # tests/test_kernels.py::test_flash_kernel_sweep
    (1, 32, 2, 2, 16),
    (2, 64, 4, 2, 32),
    (1, 100, 8, 8, 64),
    (2, 96, 6, 3, 16),
    (1, 128, 16, 4, 64),
]
WINDOW_CAP = [(0, 0.0), (13, 0.0), (0, 30.0), (13, 30.0)]
EDGES = [                    # (B, S, Hq, Hkv, D), window, cap
    ((1, 200, 4, 2, 128), 0, 30.0),     # D = 128, several kv tiles
    ((1, 300, 4, 4, 64), 100, 0.0),     # the window starts inside a kv tile
    ((2, 130, 6, 2, 32), 77, 30.0),     # Hq / Hkv = 3, ragged last tile
    ((1, 257, 8, 2, 16), 0, 0.0),       # Hq / Hkv = 4, one row in the last tile
    ((1, 300, 4, 2, 256), 100, 50.0),   # D = 256 (gemma2-9b's), its cap
    ((1, 200, 8, 1, 256), 0, 50.0),     # Hq / Hkv = 8
]


def _tanh(z, D):
    """tanh as the kernel of head dim D forms it."""
    if D <= 128:
        return torch.tanh(z)
    return 1 - 2 / (torch.exp2(2 * LOG2E * z) + 1)


def emulate(q, k, v, *, causal=True, window=0, cap=0.0):
    """q: (B, Sq, Hq, D), k/v: (B, Skv, Hkv, D) bf16 -> o in bf16, computed
    as the tensor-core kernel computes it."""
    B, Sq, Hq, D = q.shape
    Skv, G = k.shape[1], Hq // k.shape[2]
    qf = q.float()
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    scale = D ** -0.5
    q_pos = torch.arange(Sq)[:, None]
    m = torch.full((B, Hq, Sq), NEG_INF)
    l = torch.zeros((B, Hq, Sq))
    acc = torch.zeros((B, Hq, Sq, D))
    for k0 in range(0, Skv, BK):
        kt, vt = kf[:, k0:k0 + BK], vf[:, k0:k0 + BK]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kt)
        x = (cap * _tanh(s * scale / cap, D) * LOG2E if cap
             else s * (scale * LOG2E))
        kv_pos = torch.arange(k0, k0 + kt.shape[1])[None, :]
        keep = torch.ones((Sq, kt.shape[1]), dtype=torch.bool)
        if causal:
            keep &= kv_pos <= q_pos
        if window:
            keep &= kv_pos > q_pos - window
        x = torch.where(keep, x, NEG_INF)
        m_new = torch.maximum(m, x.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.bfloat16().float(), vt)
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.transpose(1, 2).bfloat16()


def _qkv(B, S, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .bfloat16()
                 for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))


def _check(shape, window, cap, seed):
    q, k, v = _qkv(*shape, seed=seed)
    got = emulate(q, k, v, window=window, cap=cap)
    want = attention_reference(q, k, v, causal=True, window=window,
                               attn_softcap=cap)
    assert got.dtype == want.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("window,cap", WINDOW_CAP)
def test_bf16_tile_rounding_meets_tolerance_on_sweep(shape, window, cap):
    _check(shape, window, cap, seed=0)


@pytest.mark.parametrize("shape,window,cap", EDGES)
def test_bf16_tile_rounding_meets_tolerance_at_edges(shape, window, cap):
    _check(shape, window, cap, seed=1)


def test_emulation_in_f32_rounding_is_the_plain_version():
    """Without the bf16 rounding of p the per-tile online softmax is the
    plain softmax to f32 rounding: what remains in the bf16 test is p's
    rounding alone."""
    q, k, v = (t.float() for t in _qkv(1, 150, 4, 2, 32, seed=2))
    B, Sq, Hq, D = q.shape
    G = Hq // k.shape[2]
    kf, vf = (t.repeat_interleave(G, dim=2) for t in (k, v))
    x = torch.einsum("bqhd,bkhd->bhqk", q, kf) * (D ** -0.5 * LOG2E)
    mask = torch.ones((Sq, Sq), dtype=torch.bool).tril()
    x = torch.where(mask, x, NEG_INF)
    m = torch.full((B, Hq, Sq), NEG_INF)
    l = torch.zeros((B, Hq, Sq))
    acc = torch.zeros((B, Hq, Sq, D))
    for k0 in range(0, Sq, BK):
        xt = x[..., k0:k0 + BK]
        m_new = torch.maximum(m, xt.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(xt - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, vf[:, k0:k0 + BK])
        m = m_new
    got = (acc / l[..., None]).transpose(1, 2)
    want = attention_reference(q, k, v, causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5, rtol=3e-5)
