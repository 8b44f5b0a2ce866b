"""The rounding of the bf16 flash-attention kernels, emulated on the CPU.

K1's bf16 kernels (csrc/flash_attention_fwd.cu) are ``flash_fwd_mma_kernel``
at head dims 16 and 32 (blocks of 64 q rows, kv tiles of 64 rows) and
``flash_fwd_wgmma_kernel`` at 64, 128 and 256 (blocks of two warpgroups,
128 q rows; kv tiles of 128 rows, 64 at head dim 256).  Both keep bf16
inputs in bf16, sum Q K^T in f32, run the online softmax per kv tile in
log2 units over the kv tiles that the block's rows can see (loop bounds
from the block's first and last row), and round the unnormalised p of
each tile to bf16 before the P V product, which sums in f32; the row sum l
takes p before rounding.  A row that sees no key writes o = 0 and lse =
-1e30; lse is (m + log2 max(l, 1e-30)) ln 2.  The wgmma kernel's cap forms
tanh as 1 - 2 / (2^(2x log2 e) + 1) (``hopper::tanh_ex2``).  The plain
version (``attention_reference``) normalises p first and rounds the
normalised p.  ``emulate`` does in torch what the kernel does, with the
kv tile width and the q rows of a block as parameters, and is held against
the plain version at the bf16 tolerance of tests/test_kernels.py (3e-2)
over the reference's sweep grid and shapes of the kernels' own edges, its
lse within chip_smoke.py's LSE_TOL: so a design meets the tolerance
before a card is used.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import (attention_reference,
                                     flash_attention_lse_plain)

TOL = 3e-2
LSE_TOL = 1e-3               # chip_smoke.py's gate on K1's lse
BK = 64                      # the kv tile of the first kernel
NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
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
# the wgmma kernel at D = 64 and 128 (kv tiles of 128 rows, blocks of 128
# q rows): (B, Sq, Skv, Hq, Hkv, D), q_offset, window, cap
WGMMA_CASES = [
    ((1, 300, 300, 4, 4, 64), 0, 0, 0.0),       # G = 1, ragged last tiles
    ((1, 257, 257, 6, 2, 64), 0, 100, 30.0),    # G = 3, one row in the last block
    ((1, 200, 200, 16, 2, 128), 0, 0, 50.0),    # G = 8, the cap
    ((1, 130, 130, 16, 1, 64), 0, 77, 0.0),     # G = 16, the window
    ((1, 256, 256, 8, 1, 128), 0, 0, 0.0),      # whole tiles only
    ((1, 96, 32, 2, 1, 64), 0, 13, 0.0),        # Sq > Skv: rows from 44 see no key
    ((1, 160, 32, 4, 2, 128), 0, 13, 30.0),
    ((2, 128, 512, 15, 5, 64), 384, 0, 0.0),    # a seq rank (q_offset)
    ((1, 129, 400, 8, 2, 128), 129, 100, 0.0),  # offset off the tiles' edges
    ((1, 200, 520, 3, 1, 128), 63, 77, 30.0),
]


def tiles(D):
    """(kv tile rows, q rows a block) of K1's bf16 kernel at head dim D."""
    if D <= 32:
        return BK, 64
    return (128 if D <= 128 else 64), 128


def _tanh(z, D):
    """tanh as the kernel of head dim D forms it."""
    if D <= 32:
        return torch.tanh(z)
    return 1 - 2 / (torch.exp2(2 * LOG2E * z) + 1)


def emulate(q, k, v, *, causal=True, window=0, cap=0.0, q_offset=0, bk=None,
            bq=None):
    """q: (B, Sq, Hq, D), k/v: (B, Skv, Hkv, D) bf16 -> (o in bf16, lse f32
    (B, Sq, Hq)), computed as the tensor-core kernel computes it, with kv
    tiles of ``bk`` rows and blocks of ``bq`` q rows (by default the
    kernel's at head dim D, ``tiles``)."""
    B, Sq, Hq, D = q.shape
    bk, bq = bk or tiles(D)[0], bq or tiles(D)[1]
    Skv, G = k.shape[1], Hq // k.shape[2]
    qf = q.float()
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    scale = D ** -0.5
    o = torch.zeros((B, Hq, Sq, D))
    lse = torch.full((B, Hq, Sq), NEG_INF)
    for q0 in range(0, Sq, bq):
        q1 = min(q0 + bq, Sq)
        q_pos = q_offset + torch.arange(q0, q1)[:, None]
        # the block's kv tiles: the kernel's loop bounds
        kv_hi = min(q_offset + q1 - 1, Skv - 1) if causal else Skv - 1
        kv_lo = max(q_offset + q0 - window + 1, 0) if window else 0
        m = torch.full((B, Hq, q1 - q0), NEG_INF)
        l = torch.zeros((B, Hq, q1 - q0))
        acc = torch.zeros((B, Hq, q1 - q0, D))
        for t in range(kv_lo // bk, kv_hi // bk + 1 if kv_hi >= kv_lo else 0):
            k0 = t * bk
            kt, vt = kf[:, k0:k0 + bk], vf[:, k0:k0 + bk]
            s = torch.einsum("bqhd,bkhd->bhqk", qf[:, q0:q1], kt)
            x = (cap * _tanh(s * scale / cap, D) * LOG2E if cap
                 else s * (scale * LOG2E))
            kv_pos = torch.arange(k0, k0 + kt.shape[1])[None, :]
            keep = torch.ones((q1 - q0, kt.shape[1]), dtype=torch.bool)
            if causal:
                keep &= kv_pos <= q_pos
            if window:
                keep &= kv_pos > q_pos - window
            # masked: -inf, so p = 0 there and m stays NEG_INF until the
            # row sees a key (the mma kernel's finite NEG_INF gives p = 1
            # on a row's masked tiles before its first key, and the
            # correction zeroes them: the same result)
            x = torch.where(keep, x, -torch.inf)
            m_new = torch.maximum(m, x.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.bfloat16().float(), vt)
            m = m_new
        seen = m > NEG_INF                      # rows that saw a key
        lc = torch.clamp(l, min=1e-30)
        o[:, :, q0:q1] = torch.where(seen[..., None], acc / lc[..., None], 0.0)
        lse[:, :, q0:q1] = torch.where(seen, (m + torch.log2(lc)) * LN2,
                                       NEG_INF)
    return o.transpose(1, 2).bfloat16(), lse.transpose(1, 2)


def _qkv(B, S, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .bfloat16()
                 for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))


def _check(shape, window, cap, seed):
    q, k, v = _qkv(*shape, seed=seed)
    got, _ = emulate(q, k, v, window=window, cap=cap)
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


@pytest.mark.parametrize("shape,q_offset,window,cap", WGMMA_CASES)
def test_wgmma_tiles_meet_tolerance(shape, q_offset, window, cap):
    """The wgmma kernel's tiles at D = 64 and 128: o against
    ``attention_reference`` on every row that sees a key and 0 on the
    others, lse against the blockwise forward's within LSE_TOL."""
    B, Sq, Skv, Hq, Hkv, D = shape
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .bfloat16()
               for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    kw = dict(causal=True, window=window, attn_softcap=cap, q_offset=q_offset)
    got, lse = emulate(q, k, v, causal=True, window=window, cap=cap,
                       q_offset=q_offset)
    want = attention_reference(q, k, v, **kw)
    _, want_lse = flash_attention_lse_plain(q, k, v, **kw)
    pos = q_offset + torch.arange(Sq)
    seen = pos < Skv + window - 1 if window else torch.ones(Sq, dtype=bool)
    np.testing.assert_allclose(got[:, seen].float().numpy(),
                               want[:, seen].float().numpy(), atol=TOL,
                               rtol=TOL)
    assert bool((got[:, ~seen] == 0).all())
    assert bool((lse[:, ~seen] == NEG_INF).all())
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=LSE_TOL,
                               rtol=0)


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
