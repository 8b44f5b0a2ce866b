"""Port parity for the Mamba2 SSD: the oracles, the kernel's plain version and
``ops.ssd`` against the reference, on the CPU.

Inputs come from numpy seeds and go to both packages.  Tolerances: 1e-5
where both sides run the same f32 arithmetic in another order (the
oracles, the chunk terms); 5e-4 where a chunked scan is held against
another route, the reference's own SSD tolerance (tests/test_kernels.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:                      # fall back to the vendored shim
    from _propshim import given, settings, st

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels import ssd as rssd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssd import ssd_chunk_kernel, ssd_chunk_plain

SWEEP = [                 # tests/test_kernels.py::test_ssd_kernel_sweep
    (1, 32, 2, 8, 4, 8),
    (2, 64, 4, 16, 8, 16),
    (1, 128, 2, 32, 16, 32),
    (2, 48, 3, 8, 8, 16),
]
EXACT, SCAN = 1e-5, 5e-4


def _inputs(B, S, H, P, N, seed=0, a_scale=0.5, a_shift=0.0):
    """x, dt (post-softplus), A (negative), B_, C_ as f32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * a_scale + a_shift).astype(np.float32)
    B_ = rng.standard_normal((B, S, N)).astype(np.float32)
    C_ = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A, B_, C_


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SWEEP)
def test_oracles_match_reference(B, S, H, P, N, chunk):
    arrs = _inputs(B, S, H, P, N)
    y_s, h_s = tref.ssd_sequential(*_t(arrs))
    ry_s, rh_s = rref.ssd_sequential(*_j(arrs))
    _close(y_s, ry_s, EXACT)
    _close(h_s, rh_s, EXACT)
    y_c, h_c = tref.ssd_reference(*_t(arrs), chunk=chunk)
    ry_c, rh_c = rref.ssd_reference(*_j(arrs), chunk=chunk)
    _close(y_c, ry_c, EXACT)
    _close(h_c, rh_c, EXACT)
    # one chunk batch of ssd_chunk_terms, term by term
    x, dt, A, B_, C_ = (a[:, :chunk] if a.ndim > 1 else a for a in arrs)
    for got, want in zip(tref.ssd_chunk_terms(*_t((x, dt, A, B_, C_))),
                         rref.ssd_chunk_terms(*_j((x, dt, A, B_, C_)))):
        assert tuple(got.shape) == want.shape
        _close(got, want, EXACT)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SWEEP)
def test_chunk_plain_matches_reference_kernel(B, S, H, P, N, chunk):
    """The kernel's plain version against the reference's Pallas kernel in
    interpret mode, term by term."""
    arrs = _inputs(B, S, H, P, N, seed=1)
    got = ssd_chunk_plain(*_t(arrs), chunk=chunk)
    want = rssd.ssd_chunk_kernel(*_j(arrs), chunk=chunk, interpret=True)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        _close(g, w, EXACT)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SWEEP)
def test_ops_ssd_matches_reference(B, S, H, P, N, chunk):
    arrs = _inputs(B, S, H, P, N, seed=2)
    y, h = tops.ssd(*_t(arrs), chunk)
    ry, rh = rops.ssd(*_j(arrs), chunk)          # interpret mode on the CPU
    _close(y, ry, SCAN)
    _close(h, rh, SCAN)
    sy, sh = rref.ssd_sequential(*_j(arrs))
    _close(y, sy, SCAN)
    _close(h, sh, SCAN)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_ssd_from_a_nonzero_state(dtype):
    """``h0`` carries history into the first chunk, as ``ssd_reference``
    and ``ssd_sequential`` take it (the reference's ``ops.ssd`` has none)."""
    B, S, H, P, N, chunk = 2, 64, 4, 16, 8, 16
    arrs = _inputs(B, S, H, P, N, seed=3)
    h0 = np.random.default_rng(4).standard_normal((B, H, P, N)).astype(np.float32)
    x, dt, A, B_, C_ = _t(arrs)
    x, B_, C_ = (t.to(dtype) for t in (x, B_, C_))
    y, h = tops.ssd(x, dt, A, B_, C_, chunk, h0=torch.from_numpy(h0))
    assert y.dtype == dtype and h.dtype == torch.float32
    # the reference sees the same (rounded) values in f32
    same = [t.float().numpy() for t in (x, dt, A, B_, C_)]
    ry, rh = rref.ssd_reference(*_j(same), chunk=chunk, h0=jnp.asarray(h0))
    sy, sh = rref.ssd_sequential(*_j(same), h0=jnp.asarray(h0))
    tol = SCAN if dtype == torch.float32 else 3e-2    # y rounds to bf16
    for want_y, want_h in ((ry, rh), (sy, sh)):
        _close(y.float(), want_y, tol)
        _close(h, want_h, SCAN)


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 3), st.integers(1, 4), st.integers(0, 1000))
def test_chunking_invariance(b, h, seed):
    """Chunked == sequential for any chunk size dividing S (property), as
    tests/test_kernels.py::test_ssd_chunking_invariance holds the reference."""
    S, P, N = 32, 8, 4
    arrs = _t(_inputs(b, S, h, P, N, seed=seed, a_scale=0.3))
    y_seq, h_seq = tref.ssd_sequential(*arrs)
    for chunk in (4, 8, 16, 32):
        for y_c, h_c in (tref.ssd_reference(*arrs, chunk=chunk),
                         tops.ssd(*arrs, chunk)):
            _close(y_c, y_seq, 1e-3)
            _close(h_c, h_seq, 1e-3)


def test_strong_decay_gives_no_nan():
    """A near -50: above the diagonal exp(cum_i - cum_j) overflows to inf,
    and the select keeps it out of the sum (a 0/1 mask product would give
    NaN)."""
    B, S, H, P, N, chunk = 1, 64, 2, 8, 8, 32
    arrs = _inputs(B, S, H, P, N, seed=5, a_scale=0.05, a_shift=np.log(50.0))
    x, dt, A, B_, C_ = _t(arrs)
    assert float(A.max()) < -40
    terms = ssd_chunk_plain(x, dt, A, B_, C_, chunk=chunk)
    assert all(bool(torch.isfinite(t).all()) for t in terms)
    y, h = tops.ssd(x, dt, A, B_, C_, chunk)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    sy, sh = tref.ssd_sequential(x, dt, A, B_, C_)
    _close(y, sy, SCAN)
    _close(h, sh, SCAN)
    ry, rh = rref.ssd_reference(*_j(arrs), chunk=chunk)
    _close(y, ry, SCAN)
    _close(h, rh, SCAN)


def _kernel_args():
    return _t(_inputs(1, 32, 2, 8, 4))


def test_kernel_wrapper_refuses_cpu_tensors():
    """On a CPU tensor the wrapper raises before it builds anything: only
    ``ops.ssd_chunk`` takes the plain version, by the tensors' device."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_chunk_kernel(*_kernel_args(), chunk=8)


def test_ops_ssd_chunk_routes_cpu_to_plain():
    args = _kernel_args()
    before = ssd_chunk_kernel.launches
    for got, want in zip(tops.ssd_chunk(*args, chunk=8),
                         ssd_chunk_plain(*args, chunk=8)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert ssd_chunk_kernel.launches == before


def test_chunk_must_divide_seq():
    with pytest.raises(ValueError, match="not divisible"):
        ssd_chunk_plain(*_kernel_args(), chunk=12)


# ------------------- the bf16 tensor-core kernel's rounding ------------------ #
#
# ``ssd_chunk_mma_kernel`` (csrc/ssd_chunk.cu) sums C B^T from bf16 values in
# f32 (the products are exact), builds M = CB * exp(cum_i - cum_j) * dt_j in
# f32 (below each warp's diagonal 16 x 16 block as CB * exp(cum_i - cum_r) *
# [exp(cum_r - cum_j) * dt_j], r the last column of j's 16-column k-step),
# and splits M and w * B into three bf16 parts whose products with the exact
# bf16 x sum in f32.  ``_bf16_kernel_emulation`` does the same in torch; it is
# held against the plain version at the reference's 5e-4 on every term.

def _split3(t):
    """t = hi + mid + lo, three bf16-representable parts (f32 tensors)."""
    hi = t.bfloat16().float()
    mid = (t - hi).bfloat16().float()
    return hi, mid, (t - hi - mid).bfloat16().float()


def _bf16_kernel_emulation(x, dt, A, B_, C_, *, chunk):
    Bsz, S, H, P = x.shape
    N, Q = B_.shape[-1], chunk
    nc = S // Q
    xf = x.float().reshape(Bsz, nc, Q, H, P)
    Bf = B_.float().reshape(Bsz, nc, Q, N)
    Cf = C_.float().reshape(Bsz, nc, Q, N)
    dtc = dt.float().reshape(Bsz, nc, Q, H)
    cum = torch.cumsum((dtc * A).double(), dim=2)             # (b, c, Q, h)
    cb = torch.einsum("bcin,bcjn->bcij", Cf, Bf)[..., None]   # (b, c, i, j, 1)
    idx = torch.arange(Q)
    ref = torch.clamp(idx | 15, max=Q - 1)                    # r of column j
    col = torch.exp((cum[:, :, ref] - cum).float()) * dtc     # (b, c, j, h)
    row = torch.exp((cum[:, :, :, None] - cum[:, :, None, ref]).float())
    pair = torch.exp((cum[:, :, :, None] - cum[:, :, None, :]).float())
    below = (idx[:, None] // 16 > idx[None, :] // 16)[..., None]
    diag = ((idx[:, None] // 16 == idx[None, :] // 16)
            & (idx[None, :] <= idx[:, None]))[..., None]
    M = torch.where(below, cb * row * col[:, :, None], 0.0)
    M = torch.where(diag, cb * pair * dtc[:, :, None], M)
    y = sum(torch.einsum("bcijh,bcjhp->bcihp", part, xf) for part in _split3(M))
    w = torch.exp((cum[:, :, -1:] - cum).float()) * dtc        # (b, c, j, h)
    wB = w[..., None] * Bf[:, :, :, None, :]                   # (b, c, j, h, n)
    st = sum(torch.einsum("bcjhp,bcjhn->bhcpn", xf, part) for part in _split3(wB))
    return (y.reshape(Bsz, S, H, P), st,
            torch.exp(cum.float()).permute(0, 3, 1, 2),
            torch.exp(cum[:, :, -1].float()).transpose(1, 2))


BF16_CASES = [            # (B, S, H, P, N, chunk), draw of tools/ssd_conditioning.py
    ((1, 512, 2, 64, 128, 256), "model"),      # mamba2-1.3b's P, N and chunk
    ((1, 32, 2, 8, 4, 8), "sweep"),
    ((2, 64, 4, 16, 8, 16), "sweep"),
    ((1, 128, 2, 32, 16, 32), "sweep"),
    ((2, 48, 3, 8, 8, 16), "sweep"),
    ((1, 320, 3, 64, 128, 160), "model"),      # ragged 16-column k-steps
]


@pytest.mark.parametrize("shape,kind", BF16_CASES)
def test_bf16_kernel_rounding_meets_tolerance(shape, kind):
    from tools.ssd_conditioning import draw
    B, S, H, P, N, chunk = shape
    args = draw(B, S, H, P, N, torch.bfloat16, kind, seed=0, device="cpu")
    got = _bf16_kernel_emulation(*args, chunk=chunk)
    want = ssd_chunk_plain(*args, chunk=chunk)
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        _close(g, w, SCAN)


def test_three_part_split_is_as_good_as_f32():
    """hi + mid + lo keeps a value to 2^-26 relative over f32's range,
    where two parts keep 2^-17 (each part rounds its remainder to 8 bits)."""
    rng = np.random.default_rng(6)
    t = torch.from_numpy((rng.standard_normal(100_000)
                          * np.exp(rng.uniform(-60, 60, 100_000)))
                         .astype(np.float32))
    hi, mid, lo = _split3(t)
    rel3 = ((hi.double() + mid.double() + lo.double()) - t.double()).abs() / t.double().abs()
    rel2 = ((hi.double() + mid.double()) - t.double()).abs() / t.double().abs()
    assert float(rel3.max()) <= 2.0 ** -26
    assert float(rel2.max()) > 2.0 ** -24        # two parts are not enough
