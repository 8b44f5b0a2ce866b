"""The port's CUDA kernels against their plain versions, on a card.

Marked ``gpu``: each test decides inside itself whether a card exists and
skips without one.  This file imports no JAX, so it runs where only the
port's dependencies are installed:
  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
Tolerances are those of tests/test_kernels.py: flash attention f32 3e-5,
bf16 3e-2 (the lse too); its backward f32 5e-5 (the reference's own VJP
tolerance) and bf16 3e-2; the SSD chunk terms and their backward 5e-4
(both routes compute in f32).  The backwards are also held per tensor,
||kernel - plain|| / ||plain|| within 1e-5 f32 and 1e-2 bf16 (the SSD
backward 1e-5 for both input types), as chip_smoke.py holds them.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_lse_plain, flash_attention_plain)
from repro_torch.kernels.ref import ssd_sequential
from repro_torch.kernels.ssd import (ssd_chunk_bwd_kernel, ssd_chunk_bwd_plain,
                                     ssd_chunk_kernel, ssd_chunk_plain)

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


def _close(got, want, tol, msg):
    np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                               want.detach().float().cpu().numpy(), atol=tol,
                               rtol=tol, err_msg=msg)


def _close_rounded(got, want, tol, norm_tol, msg):
    """got, rounded once to bf16 from an f32 sum that the plain version
    computes as want: each element is the bf16 rounding of a value within
    atol=rtol=tol of want, and ||got - want|| exceeds the error of rounding
    want itself by at most norm_tol ||want||."""
    g, want = got.float(), want.float()
    m, e = torch.frexp(g)
    half = torch.ldexp(torch.ones_like(g), e - 9)     # half a bf16 spacing
    half = torch.where((m.abs() == 0.5) & (want.abs() < g.abs()), half / 2,
                       half)
    half = torch.where(g == 0, torch.zeros_like(g), half)
    over = ((g - want).abs() - half).clamp(min=0)
    assert bool((over <= tol + tol * want.abs()).all()), msg
    rounding = (want.to(torch.bfloat16).float() - want).norm()
    assert float(((g - want).norm() - rounding) / want.norm()) <= norm_tol, msg


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_lse_matches_plain_on_cuda(dtype):
    _cuda()
    for shape in SHAPES:
        q, k, v = _qkv(*shape, dtype, seed=5)
        for window, cap in WINDOW_CAP:
            before = flash_attention_fwd.launches
            o, lse = flash_attention_fwd(q, k, v, causal=True, window=window,
                                         attn_softcap=cap, with_lse=True)
            torch.cuda.synchronize()
            assert flash_attention_fwd.launches == before + 1
            assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
            want_o, want_lse = flash_attention_lse_plain(
                q, k, v, causal=True, window=window, attn_softcap=cap)
            msg = f"{shape} {dtype} window={window} cap={cap}"
            _close(o, want_o, TOL[dtype], msg)
            _close(lse, want_lse, TOL[dtype], msg)
            # the serving call without the lse writes the same o
            assert torch.equal(o, flash_attention_fwd(
                q, k, v, causal=True, window=window, attn_softcap=cap))


BWD_TOL = {torch.float32: 5e-5, torch.bfloat16: 3e-2}
BWD_NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}   # chip_smoke.py
BWD_SHAPES = SHAPES + [(1, 1000, 6, 2, 64), (2, 300, 4, 4, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_matches_plain_on_cuda(dtype):
    _cuda()
    for shape in BWD_SHAPES:
        q, k, v = _qkv(*shape, dtype, seed=6)
        do = _qkv(*shape, dtype, seed=7)[0]
        for window, cap in WINDOW_CAP:
            o, lse = flash_attention_fwd(q, k, v, causal=True, window=window,
                                         attn_softcap=cap, with_lse=True)
            before = flash_attention_bwd.launches
            got = flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                      window=window, attn_softcap=cap)
            torch.cuda.synchronize()
            assert flash_attention_bwd.launches == before + 1
            want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True,
                                             window=window, attn_softcap=cap)
            again = flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                        window=window, attn_softcap=cap)
            for name, g, w, g2 in zip(("dq", "dk", "dv"), got, want, again):
                assert g.dtype == dtype and g.shape == w.shape, name
                assert torch.equal(g, g2), f"{name} not deterministic"
                msg = f"{name} {shape} {dtype} window={window} cap={cap}"
                _close(g, w, BWD_TOL[dtype], msg)
                rel = float((g.float() - w.float()).norm() / w.float().norm())
                assert rel <= BWD_NORM_TOL[dtype], f"{msg}: normwise {rel}"


@pytest.mark.gpu
def test_blockwise_attention_autograd_through_the_kernels_on_cuda():
    """``ops.blockwise_attention`` on CUDA tensors: K1 forward, K1b
    backward, gradients equal to autograd through the plain attention."""
    _cuda()
    B, S, Hq, Hkv, D = 2, 130, 6, 2, 32
    q, k, v = (t.requires_grad_() for t in _qkv(B, S, Hq, Hkv, D,
                                                 torch.float32, seed=8))
    do = _qkv(B, S, Hq, Hkv, D, torch.float32, seed=9)[0]
    f0, b0 = flash_attention_fwd.launches, flash_attention_bwd.launches
    out = ops.blockwise_attention(q, k, v, 0, True, 9, 20.0)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches - f0,
            flash_attention_bwd.launches - b0) == (1, 1)
    want = flash_attention_plain(q, k, v, causal=True, window=9,
                                 attn_softcap=20.0)
    wgrads = torch.autograd.grad(want, (q, k, v), do)
    _close(out, want, TOL[torch.float32], "o")
    for g, w in zip(grads, wgrads):
        _close(g, w, BWD_TOL[torch.float32], "grad")


@pytest.mark.gpu
def test_flash_bwd_refuses_what_it_does_not_take():
    _cuda()
    q, k, v = _qkv(1, 32, 2, 2, 16, torch.float32)
    o, lse = flash_attention_fwd(q, k, v, with_lse=True)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, o, lse.double(), o)
    with pytest.raises(ValueError, match="o and do"):
        flash_attention_bwd(q, k, v, o, lse, o.bfloat16())
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, k, v, o, lse, o.cpu())
    with pytest.raises(ValueError, match="head dim"):
        q8 = torch.zeros((1, 4, 2, 8), device="cuda")
        flash_attention_bwd(q8, q8, q8, q8, torch.zeros((1, 4, 2), device="cuda"), q8)
    # the bf16 path at D = 64 reads its inputs in 16-byte pieces: a
    # contiguous view that starts one element in is refused, not rerouted
    q, k, v = _qkv(1, 64, 2, 1, 64, torch.bfloat16)
    o, lse = flash_attention_fwd(q, k, v, with_lse=True)
    buf = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device="cuda")
    shifted = buf[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd(shifted, k, v, o, lse, o)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd(q, k, v, o, lse, shifted)


# (B, Sq, Skv, Hq, Hkv, D), causal, window, cap: a D=128 shape with
# several kv tiles, rows that see no key (Sq > Skv + window - 1) on each
# bf16 route: D=16 (mma.sync), 64 and 128 (wgmma), and attention that is
# not causal
BWD_CASES = [
    ((2, 512, 512, 16, 8, 128), True, 0, 0.0),
    ((1, 96, 32, 2, 1, 16), True, 13, 0.0),
    ((1, 96, 32, 2, 1, 64), True, 13, 30.0),
    ((1, 160, 32, 4, 2, 128), True, 13, 0.0),
    ((2, 200, 70, 6, 3, 64), True, 9, 0.0),
    ((2, 150, 90, 6, 2, 64), False, 0, 0.0),
    ((1, 100, 130, 4, 4, 128), False, 0, 30.0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal,window,cap", BWD_CASES)
def test_flash_bwd_d128_and_rows_without_key_on_cuda(shape, causal, window,
                                                     cap, dtype):
    """K1b against its plain version, bitwise repeatable; on rows that see
    no key K1 writes o = 0 and lse = -1e30, and K1b gives dq = 0 there and
    leaves dk, dv bitwise unchanged by a nonzero do on those rows."""
    _cuda()
    B, Sq, Skv, Hq, Hkv, D = shape
    rng = np.random.default_rng(11)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   .to("cuda", dtype)
                   for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D),
                             (B, Skv, Hkv, D), (B, Sq, Hq, D)))
    kw = dict(causal=causal, window=window, attn_softcap=cap)
    o, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for name, g, w, g2 in zip(("dq", "dk", "dv"), got, want, again):
        assert torch.equal(g, g2), f"{name} not deterministic"
        msg = f"{name} {shape} {dtype} window={window} cap={cap}"
        _close(g, w, BWD_TOL[dtype], msg)
        rel = float((g.float() - w.float()).norm() / w.float().norm())
        assert rel <= BWD_NORM_TOL[dtype], f"{msg}: normwise {rel}"
    seen = Skv + window - 1 if window else Sq      # rows from here see no key
    if seen < Sq:
        assert bool((o[:, seen:] == 0).all())
        assert bool((lse[:, seen:] == -1e30).all())
        assert bool((got[0][:, seen:] == 0).all())
        quiet = do.clone()
        quiet[:, seen:] = 0
        calm = flash_attention_bwd(q, k, v, o, lse, quiet, **kw)
        assert torch.equal(got[1], calm[1]) and torch.equal(got[2], calm[2])


# head dim 256 (gemma2-9b): in bf16 K1 on wgmma with two warpgroups of 64
# q rows a block (128-row tiles), K1b's dk/dv on wgmma with two warpgroups
# splitting the products of 64 kv rows and its dq laid out as K1; f32 on
# 32-row tiles.  (B, Sq, Skv, Hq, Hkv, D), causal, window, cap: ragged q
# and kv tiles (lengths not multiples of 64 or 128, Sq != Skv both ways),
# G = 1, 2 and 8, windows that cut inside a 128-row tile, cap 0 and 50,
# rows that see no key, attention that is not causal
D256_CASES = [
    ((1, 300, 300, 4, 2, 256), True, 0, 0.0),
    ((2, 200, 200, 4, 2, 256), True, 77, 50.0),
    ((1, 260, 260, 16, 8, 256), True, 0, 50.0),
    ((1, 160, 32, 2, 1, 256), True, 13, 0.0),
    ((1, 100, 130, 2, 1, 256), False, 0, 30.0),
    ((1, 200, 257, 4, 4, 256), True, 0, 0.0),
    ((1, 257, 200, 8, 1, 256), True, 0, 50.0),
    ((1, 300, 300, 8, 1, 256), True, 100, 50.0),
    ((2, 257, 257, 2, 2, 256), True, 77, 0.0),
    ((1, 200, 40, 2, 1, 256), True, 13, 50.0),
    ((1, 300, 200, 4, 2, 256), False, 0, 0.0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal,window,cap", D256_CASES)
def test_flash_d256_matches_plain_on_cuda(shape, causal, window, cap, dtype):
    """K1 (o and lse) and K1b at head dim 256 against their plain versions,
    K1b bitwise repeatable; each call launches its kernel.  On rows that
    see no key K1 writes o = 0 and lse = -1e30, and K1b gives dq = 0 there
    and leaves dk, dv bitwise unchanged by a nonzero do on those rows."""
    _cuda()
    B, Sq, Skv, Hq, Hkv, D = shape
    rng = np.random.default_rng(12)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   .to("cuda", dtype)
                   for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D),
                             (B, Skv, Hkv, D), (B, Sq, Hq, D)))
    kw = dict(causal=causal, window=window, attn_softcap=cap)
    f0, b0 = flash_attention_fwd.launches, flash_attention_bwd.launches
    o, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches - f0,
            flash_attention_bwd.launches - b0) == (1, 2)
    msg = f"{shape} {dtype} window={window} cap={cap}"
    want_o, want_lse = flash_attention_lse_plain(q, k, v, **kw)
    _close(o, want_o, TOL[dtype], f"o {msg}")
    _close(lse, want_lse, TOL[dtype], f"lse {msg}")
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for name, g, w, g2 in zip(("dq", "dk", "dv"), got, want, again):
        assert torch.equal(g, g2), f"{name} not deterministic"
        _close(g, w, BWD_TOL[dtype], f"{name} {msg}")
        rel = float((g.float() - w.float()).norm() / w.float().norm())
        assert rel <= BWD_NORM_TOL[dtype], f"{name} {msg}: normwise {rel}"
    seen = Skv + window - 1 if window else Sq      # rows from here see no key
    if causal and seen < Sq:
        assert bool((o[:, seen:] == 0).all())
        assert bool((lse[:, seen:] == -1e30).all())
        assert bool((got[0][:, seen:] == 0).all())
        quiet = do.clone()
        quiet[:, seen:] = 0
        calm = flash_attention_bwd(q, k, v, o, lse, quiet, **kw)
        assert torch.equal(got[1], calm[1]) and torch.equal(got[2], calm[2])


# q_offset: q's row i at position q_offset + i, the per-rank body of the
# sequence-parallel strategy.  (B, Sq, Skv, Hq, Hkv, D), q_offset, window,
# cap: chunks of a seq-parallel split (Sq = Skv / M at offset r Skv / M) in
# every family (bf16 mma.sync at D = 16/32, wgmma at D = 64-256, in K1
# and K1b; f32 at every D), offsets on
# and off the 64- and 128-row tile edges, Sq that divides no tile,
# windows that cut inside a tile, and chunks whose every kv tile is whole
# (no mask) beside the diagonal's
Q_OFFSET_CASES = [
    ((2, 64, 128, 2, 2, 16), 64, 0, 0.0),
    ((1, 100, 200, 4, 2, 32), 100, 13, 30.0),
    ((2, 128, 512, 15, 5, 64), 384, 0, 0.0),
    ((1, 70, 300, 6, 2, 64), 65, 77, 0.0),
    ((1, 96, 256, 4, 4, 128), 127, 0, 30.0),
    ((1, 129, 400, 8, 2, 128), 129, 100, 0.0),
    ((1, 128, 256, 4, 2, 256), 128, 0, 50.0),
    ((1, 200, 520, 2, 1, 256), 63, 77, 50.0),
    ((1, 130, 260, 4, 2, 256), 130, 0, 0.0),
    ((1, 128, 512, 16, 1, 64), 256, 0, 0.0),
    ((1, 192, 520, 3, 1, 128), 200, 0, 50.0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,q_offset,window,cap", Q_OFFSET_CASES)
def test_flash_q_offset_matches_plain_on_cuda(shape, q_offset, window, cap,
                                              dtype):
    """K1 (o and lse) and K1b with q_offset against their plain versions,
    K1b bitwise repeatable; and, for a split of the whole sequence into
    chunks at their offsets, the chunks' o side by side and the sum of
    their dk, dv equal the unsharded call's within the same tolerances."""
    _cuda()
    B, Sq, Skv, Hq, Hkv, D = shape
    rng = np.random.default_rng(13)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   .to("cuda", dtype)
                   for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D),
                             (B, Skv, Hkv, D), (B, Sq, Hq, D)))
    kw = dict(causal=True, window=window, attn_softcap=cap, q_offset=q_offset)
    o, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
    want_o, want_lse = flash_attention_lse_plain(q, k, v, **kw)
    msg = f"{shape} {dtype} q_offset={q_offset} window={window} cap={cap}"
    _close(o, want_o, TOL[dtype], msg)
    _close(lse, want_lse, TOL[dtype], msg)
    assert torch.equal(o, flash_attention_fwd(q, k, v, **kw))
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for name, g, w, g2 in zip(("dq", "dk", "dv"), got, want, again):
        assert torch.equal(g, g2), f"{name} not deterministic"
        _close(g, w, BWD_TOL[dtype], f"{name} {msg}")
        rel = float((g.float() - w.float()).norm() / w.float().norm())
        assert rel <= BWD_NORM_TOL[dtype], f"{name} {msg}: normwise {rel}"
    # the whole sequence in chunks of Sq at their offsets (f32: the sums
    # of dk, dv across chunks are in f32 there)
    if dtype != torch.float32 or Skv % Sq:
        return
    qa, doa = (torch.from_numpy(rng.standard_normal((B, Skv, Hq, D)).astype(
        np.float32)).cuda() for _ in range(2))
    full = dict(kw, q_offset=0)
    oa, la = flash_attention_fwd(qa, k, v, with_lse=True, **full)
    ga = flash_attention_bwd(qa, k, v, oa, la, doa, **full)
    parts, dk, dv = [], torch.zeros_like(k), torch.zeros_like(v)
    for r in range(Skv // Sq):
        sl = slice(r * Sq, (r + 1) * Sq)
        c = dict(kw, q_offset=r * Sq)
        qc, dc = qa[:, sl].contiguous(), doa[:, sl].contiguous()
        oc, lc = flash_attention_fwd(qc, k, v, with_lse=True, **c)
        dqc, dkc, dvc = flash_attention_bwd(qc, k, v, oc, lc, dc, **c)
        parts.append((oc, dqc))
        dk, dv = dk + dkc, dv + dvc
    _close(torch.cat([p[0] for p in parts], 1), oa, TOL[dtype], f"o {msg}")
    _close(torch.cat([p[1] for p in parts], 1), ga[0], BWD_TOL[dtype],
           f"dq {msg}")
    _close(dk, ga[1], BWD_TOL[dtype], f"dk {msg}")
    _close(dv, ga[2], BWD_TOL[dtype], f"dv {msg}")


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
def test_flash_fwd_refuses_misaligned_bf16_views(D):
    """K1 reads bf16 inputs at head dims 64 and 128 by TMA too: a
    contiguous view that starts one element in is refused, not rerouted
    (no launch)."""
    _cuda()
    q, k, v = _qkv(1, 200, 4, 2, D, torch.bfloat16)
    for i in range(3):
        buf = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device="cuda")
        args = [q, k, v]
        shifted = buf[1:args[i].numel() + 1].view(args[i].shape)
        shifted.copy_(args[i])
        assert shifted.is_contiguous() and shifted.data_ptr() % 16
        args[i] = shifted
        before = flash_attention_fwd.launches
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention_fwd(*args)
        assert flash_attention_fwd.launches == before


@pytest.mark.gpu
def test_flash_d256_refuses_misaligned_bf16_views():
    """K1 and K1b read bf16 inputs at head dim 256 by TMA: a contiguous
    view that starts one element in is refused, not rerouted."""
    _cuda()
    q, k, v = _qkv(1, 64, 2, 1, 256, torch.bfloat16)
    o, lse = flash_attention_fwd(q, k, v, with_lse=True)
    buf = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device="cuda")
    shifted = buf[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    kbuf = torch.zeros(k.numel() + 1, dtype=torch.bfloat16, device="cuda")
    kshift = kbuf[1:].view(k.shape)
    kshift.copy_(k)
    for args in ((shifted, k, v), (q, kshift, v), (q, k, kshift)):
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention_fwd(*args)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd(shifted, k, v, o, lse, o)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd(q, k, v, o, lse, shifted)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd(q, kshift, v, o, lse, o)


# the other archs' heads at small shapes: musicgen's MHA (one q head per kv
# head) at D=64, internvl2's 8 q heads per kv head and internlm2's 2 at
# D=128, granite's 4 and qwen3-moe's 16 at D=64, dbrx's 6 at D=128 (K1's
# and K1b's wgmma paths in bf16: kv tiles of 128 rows in K1, blocks of 128
# q rows); several kv tiles, ragged last tiles and q blocks, with and
# without a window and cap.  (B, S, Hq, Hkv, D), window, cap
ARCH_HEAD_CASES = [
    ((2, 200, 4, 4, 64), 0, 0.0),          # musicgen-large: G = 1
    ((1, 300, 6, 6, 64), 37, 30.0),
    ((1, 260, 16, 2, 128), 0, 0.0),        # internvl2-76b: G = 8
    ((2, 130, 8, 1, 128), 45, 50.0),
    ((1, 200, 4, 2, 128), 0, 0.0),         # internlm2-1.8b: G = 2
    ((1, 150, 8, 2, 64), 0, 0.0),          # granite-3-2b: G = 4
    ((1, 257, 16, 1, 64), 100, 0.0),       # qwen3-moe: G = 16
    ((1, 384, 12, 2, 128), 0, 30.0),       # dbrx-132b: G = 6, whole tiles
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,window,cap", ARCH_HEAD_CASES)
def test_flash_at_the_other_archs_heads_on_cuda(shape, window, cap, dtype):
    """K1 (o and lse) and K1b against their plain versions at the head
    layouts of musicgen, internvl2, internlm2 and granite, K1b bitwise
    repeatable; each call launches its kernel."""
    _cuda()
    B, S, Hq, Hkv, D = shape
    q, k, v = _qkv(B, S, Hq, Hkv, D, dtype, seed=21)
    do = _qkv(B, S, Hq, Hkv, D, dtype, seed=22)[0]
    kw = dict(causal=True, window=window, attn_softcap=cap)
    f0, b0 = flash_attention_fwd.launches, flash_attention_bwd.launches
    o, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches - f0,
            flash_attention_bwd.launches - b0) == (1, 2)
    msg = f"{shape} {dtype} window={window} cap={cap}"
    want_o, want_lse = flash_attention_lse_plain(q, k, v, **kw)
    _close(o, want_o, TOL[dtype], f"o {msg}")
    _close(lse, want_lse, TOL[dtype], f"lse {msg}")
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for name, g, w, g2 in zip(("dq", "dk", "dv"), got, want, again):
        assert torch.equal(g, g2), f"{name} not deterministic"
        _close(g, w, BWD_TOL[dtype], f"{name} {msg}")
        rel = float((g.float() - w.float()).norm() / w.float().norm())
        assert rel <= BWD_NORM_TOL[dtype], f"{name} {msg}: normwise {rel}"


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
    # the edge between the wgmma route (P 64 or 128, N a multiple of 16 up
    # to 256, Q a multiple of 64 up to 256) and mma.sync
    ((2, 256, 3, 64, 16, 64), "split"),
    ((1, 256, 2, 64, 256, 256), "split"),
    ((2, 512, 4, 128, 128, 256), "split"),
    ((1, 256, 2, 64, 8, 64), "split"),
    ((1, 256, 2, 64, 128, 32), "split"),
    ((1, 256, 2, 64, 128, 256), "unaligned"),
]

# the route ssd_route gives each case of the route's edge
SSD_ROUTE_EDGE = [
    ((2, 256, 3, 64, 16, 64), "split", "wgmma"),
    ((1, 256, 2, 64, 256, 256), "split", "wgmma"),
    ((2, 512, 4, 128, 128, 256), "split", "wgmma"),
    ((8, 1024, 64, 64, 128, 256), "split", "wgmma"),
    ((1, 256, 2, 64, 8, 64), "split", "mma"),
    ((1, 256, 2, 64, 128, 32), "split", "mma"),
    ((1, 256, 2, 32, 128, 256), "split", "mma"),
    ((1, 256, 2, 64, 128, 256), "unaligned", "mma"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,layout,route", SSD_ROUTE_EDGE)
def test_ssd_route_edge_on_cuda(shape, layout, route):
    from repro_torch.kernels.ssd import ssd_route
    _cuda()
    B, S, H, P, N, chunk = shape
    x, dt, A, B_, C_ = _relaid(_ssd_inputs(B, S, H, P, N, torch.bfloat16),
                               layout)
    assert ssd_route(x, B_, C_, chunk) == route


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


@pytest.mark.gpu
def test_cuda_tensor_crosses_the_serializer_to_the_cpu():
    """What crosses a process boundary never needs a CUDA context: a CUDA
    tensor, and one inside a pytree, arrive as CPU tensors."""
    _cuda()
    from repro_torch.core import serializer
    t = torch.arange(6, dtype=torch.float32, device="cuda")
    out = serializer.loads(serializer.dumps({"w": t, "meta": [t * 2, "x"]}))
    assert out["w"].device.type == "cpu" and out["meta"][0].device.type == "cpu"
    assert torch.equal(out["w"], t.cpu()) and torch.equal(out["meta"][0],
                                                          (t * 2).cpu())


@pytest.mark.gpu
def test_pilot_runs_an_spmd_task_on_the_card():
    """A pilot without devices takes the visible CUDA devices; its spmd
    task's sub-mesh is cuda:0, and the body's result is on the card."""
    _cuda()
    from repro_torch.core import (DataFlowKernel, PilotDescription,
                                  RPEXExecutor, python_app, spmd_app)
    rpex = RPEXExecutor(PilotDescription(n_slots=2))
    try:
        assert rpex.pilot.executor.devices[0] == torch.device("cuda", 0)

        @spmd_app(slots=1, jit=False)
        def on_card(mesh, x):
            return x.to(mesh.device) * 2.0, str(mesh.device)

        @python_app
        def total(pair):
            return float(pair[0].sum())

        with DataFlowKernel(executors={"rpex": rpex}):
            f = on_card(torch.ones(8))
            y, where = f.result()
            assert where == "cuda:0" and y.device == torch.device("cuda", 0)
            assert total(f).result() == 16.0
    finally:
        rpex.shutdown()


def _conditioned(params):
    """wq, wk and wv rescaled to fan_in = d_model, as chip_smoke.smoke_params
    does: at the reference's init attention is a near-hard argmax that
    amplifies rounding layer by layer (tests/test_torch_model.py)."""
    for layer in params["layers"]:
        if "wq" in layer["mixer"]:
            for name in ("wq", "wk", "wv"):
                w = layer["mixer"][name]
                w.mul_((w.shape[-2] / w.shape[0]) ** 0.5)
    return params


@pytest.mark.gpu
@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "jamba-1.5-large-398b"])
def test_moe_prefill_on_cuda_matches_the_cpu(arch, dispatch):
    """Reduced MoE archs in f32: the prefill on the card, through K1 (and
    K2 in jamba's mamba layers), against the same port on the CPU (the
    plain versions), logits and caches within 1e-4; K1 launched once per
    attention layer and K2 once per mamba layer."""
    _cuda()
    import dataclasses
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(reduce_config(get_config(arch)), dtype="float32",
                              moe_dispatch=dispatch)
    params = _conditioned(T.init_params(cfg, 0, device="cpu"))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32)))
    prefill = M.make_prefill_step(cfg)
    want, want_cache = prefill(params, {"tokens": toks})
    gparams = tree_map(lambda t: t.cuda(), params)
    kinds = [kind for kind, _ in T.layer_program(cfg)]
    f0, s0 = flash_attention_fwd.launches, ssd_chunk_kernel.launches
    got, cache = prefill(gparams, {"tokens": toks.cuda()})
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches - f0 == kinds.count("attn")
    assert ssd_chunk_kernel.launches - s0 == kinds.count("mamba")
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)
    for c, w in zip(cache, want_cache):
        for t, u in zip(c, w):
            np.testing.assert_allclose(t.cpu().numpy(), u.numpy(), atol=1e-4,
                                       rtol=1e-4)


# the SSD backward K2b: the sweep's shapes, a ragged chunk (Q = 50: tiles of
# 32 rows cut short), P and N that the thread tiles do not fill (40, 20;
# 100, 200), mamba2's P, N and chunk, and the three layouts of x, B and C
SSD_BWD_CASES = [        # (B, S, H, P, N, chunk), layout
    ((1, 32, 2, 8, 4, 8), "split"),
    ((2, 64, 4, 16, 8, 16), "split"),
    ((2, 48, 3, 8, 8, 16), "contiguous"),
    ((1, 100, 2, 40, 20, 50), "unaligned"),
    # P, N and the chunk not multiples of 16, 16-byte copies allowed
    ((2, 90, 3, 24, 40, 30), "split"),
    ((1, 128, 3, 100, 200, 64), "split"),
    ((1, 512, 2, 64, 128, 256), "split"),
    ((8, 1024, 64, 64, 128, 256), "split"),     # mamba2-1.3b's training shape
    # the edge between the wgmma route and mma.sync (SSD_ROUTE_EDGE)
    ((2, 512, 4, 128, 128, 256), "split"),      # jamba's P
    ((2, 256, 3, 64, 16, 64), "split"),
    ((1, 256, 2, 64, 256, 128), "split"),
    ((1, 256, 2, 64, 8, 64), "split"),
    ((1, 256, 2, 64, 128, 32), "split"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,layout", SSD_BWD_CASES)
def test_ssd_chunk_bwd_kernel_matches_plain_on_cuda(shape, layout, dtype):
    _cuda()
    B, S, H, P, N, chunk = shape
    nc = S // chunk
    args = _relaid(_ssd_inputs(B, S, H, P, N, dtype, seed=5), layout)
    g = torch.Generator(device="cuda").manual_seed(6)
    cts = [torch.randn(s, device="cuda", generator=g)
           for s in ((B, S, H, P), (B, H, nc, P, N), (B, H, nc, chunk),
                     (B, H, nc))]
    before = ssd_chunk_bwd_kernel.launches
    got = ops.ssd_chunk_grads(*args, *cts, chunk=chunk)
    again = ssd_chunk_bwd_kernel(*args, *cts, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_chunk_bwd_kernel.launches == before + 2
    want = ssd_chunk_bwd_plain(*args, *cts, chunk=chunk)
    # dx's f32 sum before its one rounding to x's type: the same function
    # on the inputs upcast (exactly) to f32
    dx32 = ssd_chunk_bwd_plain(*(t.float() for t in args), *cts,
                               chunk=chunk)[0]
    assert got[0].dtype == dtype
    for name, a, a2, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, again,
                              want):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert torch.equal(a, a2), name                  # deterministic
        assert bool(torch.isfinite(a).all()), name
        msg = f"{name} {shape} {layout} {dtype}"
        if a.dtype == torch.bfloat16:
            _close_rounded(a, dx32, SSD_TOL, 1e-5, msg)
            continue
        _close(a, w, SSD_TOL, msg)
        assert float((a - w).norm() / w.norm()) <= 1e-5, msg


@pytest.mark.gpu
def test_ssd_backward_through_the_kernels_matches_sequential_on_cuda():
    """``ops.ssd``'s gradients from a nonzero state (K2, K2b, and the
    recurrence through K3 and K3b), dh0 included, against autograd through
    the step-by-step recurrence; each kernel launched once."""
    _cuda()
    B, S, H, P, N, chunk = 2, 64, 4, 16, 8, 16
    ins = [t.detach().requires_grad_()
           for t in _ssd_inputs(B, S, H, P, N, torch.float32, seed=7)]
    g = torch.Generator(device="cuda").manual_seed(8)
    h0 = torch.randn((B, H, P, N), device="cuda", generator=g).requires_grad_()
    cts = [torch.randn(s, device="cuda", generator=g)
           for s in ((B, S, H, P), (B, H, P, N))]
    from repro_torch.kernels.ssd_pass import (ssd_pass_bwd_kernel,
                                              ssd_pass_kernel)
    k0, b0 = ssd_chunk_kernel.launches, ssd_chunk_bwd_kernel.launches
    p0, q0 = ssd_pass_kernel.launches, ssd_pass_bwd_kernel.launches
    got = torch.autograd.grad(ops.ssd(*ins, chunk, h0=h0), ins + [h0], cts)
    torch.cuda.synchronize()
    assert (ssd_chunk_kernel.launches - k0,
            ssd_chunk_bwd_kernel.launches - b0) == (1, 1)
    assert (ssd_pass_kernel.launches - p0,
            ssd_pass_bwd_kernel.launches - q0) == (1, 1)
    want = torch.autograd.grad(ssd_sequential(*ins, h0=h0), ins + [h0], cts)
    for a, w in zip(got, want):
        _close(a, w, SSD_TOL, "ops.ssd backward")


# the recurrence between chunks, K3 and K3b: the mma.sync route (bf16, P 64
# or 128, N a multiple of 8 up to 128; C read through split or unaligned
# views, a ragged 64-row tile) and the CUDA cores (f32, other bf16 shapes)
SSD_PASS_CASES = [       # (B, S, H, P, N, chunk), layout, dtype
    ((2, 512, 3, 64, 128, 256), "split", torch.bfloat16),
    ((1, 320, 2, 128, 128, 160), "split", torch.bfloat16),
    ((1, 256, 2, 64, 24, 64), "unaligned", torch.bfloat16),
    ((2, 64, 4, 16, 8, 16), "split", torch.bfloat16),
    ((2, 64, 4, 16, 8, 16), "split", torch.float32),
    ((1, 512, 2, 64, 128, 256), "contiguous", torch.float32),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,layout,dtype", SSD_PASS_CASES)
def test_ssd_pass_kernels_match_plain_on_cuda(shape, layout, dtype):
    """K3 and K3b against their plain versions from a nonzero state, each
    output and gradient within SSD_TOL and 1e-5 normwise (both form the
    same f32 products), bf16 y through its one rounding; twice, bitwise
    equal."""
    from repro_torch.kernels.ref import ssd_pass_bwd_plain, ssd_pass_plain
    from repro_torch.kernels.ssd_pass import (ssd_pass_bwd_kernel,
                                              ssd_pass_kernel)
    _cuda()
    B, S, H, P, N, chunk = shape
    x, dt, A, B_, C_ = _relaid(_ssd_inputs(B, S, H, P, N, dtype, seed=9),
                               layout)
    terms = ops.ssd_chunk(x, dt, A, B_, C_, chunk=chunk)
    g = torch.Generator(device="cuda").manual_seed(10)
    h0 = torch.randn((B, H, P, N), device="cuda", generator=g)
    dy = torch.randn((B, S, H, P), device="cuda", generator=g).to(dtype)
    dhT = torch.randn((B, H, P, N), device="cuda", generator=g)
    k0, b0 = ssd_pass_kernel.launches, ssd_pass_bwd_kernel.launches
    got = ops.ssd_pass(*terms, C_, h0, dtype=dtype)
    assert torch.equal(got[0], ssd_pass_kernel(*terms, C_, h0, dtype=dtype)[0])
    want = ssd_pass_plain(*terms, C_, h0, dtype=torch.float32)
    grads = ops.ssd_pass_grads(dy, dhT, want[2], *terms[2:], C_,
                               with_dh0=True)
    again = ssd_pass_bwd_kernel(dy, dhT, want[2], *terms[2:], C_,
                                with_dh0=True)
    torch.cuda.synchronize()
    assert (ssd_pass_kernel.launches - k0,
            ssd_pass_bwd_kernel.launches - b0) == (2, 2)
    msg = f"{shape} {layout} {dtype}"
    assert got[0].dtype == dtype
    if dtype == torch.bfloat16:
        _close_rounded(got[0], want[0], SSD_TOL, 1e-5, f"y {msg}")
    for name, a, w in (("y", got[0], want[0]), ("hT", got[1], want[1]),
                       ("h_prev", got[2], want[2]),
                       *zip(("d y_intra", "d states", "d decay_all",
                             "d decay_chunk", "dC", "dh0"), grads,
                            ssd_pass_bwd_plain(dy, dhT, want[2], *terms[2:],
                                               C_))):
        if name == "y" and dtype == torch.bfloat16:
            continue
        assert bool(torch.isfinite(a).all()), name
        _close(a, w, SSD_TOL, f"{name} {msg}")
        assert float((a - w).norm() / w.norm()) <= 1e-5, f"{name} {msg}"
    for a, a2 in zip(grads, again):
        assert torch.equal(a, a2)                       # deterministic


@pytest.mark.gpu
def test_ssd_pass_takes_views_of_the_chunk_terms_on_cuda():
    """``ops.ssd_pass`` on strided views of K2's terms and of h0 (what a
    plain ``ssd_chunk`` swapped in on the card hands it) gives what it
    gives on the dense tensors."""
    _cuda()
    B, S, H, P, N, chunk = 2, 64, 4, 16, 8, 16
    x, dt, A, B_, C_ = _ssd_inputs(B, S, H, P, N, torch.float32, seed=11)
    terms = ops.ssd_chunk(x, dt, A, B_, C_, chunk=chunk)
    h0 = torch.randn((B, H, P, N), device="cuda")
    views = [t.transpose(0, 1).contiguous().transpose(0, 1)
             for t in (*terms, h0)]
    assert not any(v.is_contiguous() for v in views)
    got = ops.ssd_pass(*views[:4], C_, views[4], dtype=torch.float32)
    want = ops.ssd_pass(*terms, C_, h0, dtype=torch.float32)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.gpu
def test_ssd_chunk_bwd_kernel_refuses_what_it_does_not_take():
    _cuda()
    x, dt, A, B_, C_ = _ssd_inputs(1, 32, 2, 8, 4, torch.float32)
    cts = [torch.zeros(s, device="cuda")
           for s in ((1, 32, 2, 8), (1, 2, 4, 8, 4), (1, 2, 4, 8), (1, 2, 4))]
    with pytest.raises(ValueError, match="contiguous float32"):
        ssd_chunk_bwd_kernel(x, dt, A, B_, C_, cts[0].double(), *cts[1:],
                             chunk=8)
    with pytest.raises(ValueError, match="contiguous float32"):
        ssd_chunk_bwd_kernel(x, dt, A, B_, C_, *cts, chunk=16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_chunk_bwd_kernel(x.cpu(), dt, A, B_, C_, *cts, chunk=8)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_train_step_on_cuda_matches_the_cpu(arch):
    """Reduced archs in f32: one loss and grad on the card (K1, K1b, K2 and
    K2b under remat "full") against the same port on the CPU (the plain
    versions), loss within 1e-5 and every grad leaf within 1e-4 of its
    largest magnitude, the MoE layers drop-free (capacity factor E/K) so
    that both devices route alike."""
    _cuda()
    import dataclasses
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves, tree_map
    cfg = reduce_config(get_config(arch))
    over = dict(dtype="float32")
    if cfg.num_experts:
        over["capacity_factor"] = cfg.num_experts / cfg.num_experts_per_tok
    cfg = dataclasses.replace(cfg, **over)
    params = _conditioned(T.init_params(cfg, 0, device="cpu"))
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (2, 33))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:]),
             "loss_mask": torch.ones((2, 32))}
    loss_and_grad = M.make_loss_and_grad(cfg)
    want, wm = loss_and_grad(params, batch)
    kinds = [kind for kind, _ in T.layer_program(cfg)]
    n_attn, n_ssd = kinds.count("attn"), kinds.count("mamba")
    before = (flash_attention_fwd.launches, flash_attention_bwd.launches,
              ssd_chunk_kernel.launches, ssd_chunk_bwd_kernel.launches)
    got, gm = loss_and_grad(tree_map(lambda t: t.cuda(), params),
                            {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    after = (flash_attention_fwd.launches, flash_attention_bwd.launches,
             ssd_chunk_kernel.launches, ssd_chunk_bwd_kernel.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (
        2 * n_attn, n_attn, 2 * n_ssd, n_ssd)
    assert abs(float(gm["loss"]) - float(wm["loss"])) <= 1e-5
    for a, w in zip(leaves(got), leaves(want)):
        scale = float(w.abs().max())
        assert bool(torch.isfinite(a).all()) and scale > 0
        assert float((a.cpu() - w).abs().max()) <= 1e-4 * scale


@pytest.mark.gpu
def test_gemma2_prefill_on_cuda_matches_the_cpu():
    """Reduced gemma2-9b in f32, 40 positions past its reduced window of 8:
    the prefill on the card, through K1 in every layer (the window on the
    local layers, the attention cap 50 on all, the logit cap 30), against
    the same port on the CPU (the plain versions), logits and caches within
    1e-4."""
    _cuda()
    import dataclasses
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(reduce_config(get_config("gemma2-9b")),
                              dtype="float32")
    assert cfg.sliding_window == 8 and cfg.local_global_alternate
    params = _conditioned(T.init_params(cfg, 0, device="cpu"))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 40)))
    prefill = M.make_prefill_step(cfg)
    want, want_cache = prefill(params, {"tokens": toks})
    f0 = flash_attention_fwd.launches
    got, cache = prefill(tree_map(lambda t: t.cuda(), params),
                         {"tokens": toks.cuda()})
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches - f0 == cfg.num_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)
    for c, w in zip(cache, want_cache):
        for t, u in zip(c, w):
            np.testing.assert_allclose(t.cpu().numpy(), u.numpy(), atol=1e-4,
                                       rtol=1e-4)


@pytest.mark.gpu
def test_vlm_train_step_on_cuda_matches_the_cpu():
    """Reduced internvl2-76b in f32 with 4 patch positions in front of 32
    text tokens: one loss and grad on the card (K1 twice and K1b once a
    layer under remat "full") against the same port on the CPU, loss
    within 1e-5 and every grad leaf, the connector's included, within 1e-4
    of its largest magnitude; then an AdamW step on the card."""
    _cuda()
    import dataclasses
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamW
    from repro_torch.tree import leaves, tree_map
    cfg = dataclasses.replace(reduce_config(get_config("internvl2-76b")),
                              dtype="float32")
    params = _conditioned(T.init_params(cfg, 0, device="cpu"))
    rng = np.random.default_rng(10)
    toks = rng.integers(0, cfg.vocab_size, (2, 33))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:]),
             "loss_mask": torch.ones((2, 32)),
             "patches": torch.from_numpy(rng.standard_normal(
                 (2, cfg.frontend_tokens, cfg.d_model), np.float32))}
    loss_and_grad = M.make_loss_and_grad(cfg)
    want, wm = loss_and_grad(params, batch)
    gparams = tree_map(lambda t: t.cuda(), params)
    gbatch = {k: v.cuda() for k, v in batch.items()}
    f0, b0 = flash_attention_fwd.launches, flash_attention_bwd.launches
    got, gm = loss_and_grad(gparams, gbatch)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches - f0,
            flash_attention_bwd.launches - b0) == (2 * cfg.num_layers,
                                                   cfg.num_layers)
    assert abs(float(gm["loss"]) - float(wm["loss"])) <= 1e-5
    assert float(got["connector"]["wi"].abs().max()) > 0
    for a, w in zip(leaves(got), leaves(want)):
        scale = float(w.abs().max())
        assert bool(torch.isfinite(a).all()) and scale > 0
        assert float((a.cpu() - w).abs().max()) <= 1e-4 * scale
    opt = AdamW()
    _, _, metrics = M.make_train_step(cfg, opt)(gparams, opt.init(gparams),
                                                gbatch)
    assert bool(torch.isfinite(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0
