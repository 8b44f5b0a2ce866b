"""Port parity for the SSD backward on the CPU: the plain version of K2b
(``ssd_chunk_bwd_plain``) and the gradients of ``ops.ssd`` (K2 and K2b's
plain versions under ``_SSDChunk``, the recurrence between chunks by
autograd) against the reference's VJPs.

Inputs come from numpy seeds and go to both packages.  Tolerance: 1e-4
relative to the largest magnitude of the leaf it holds, against the
reference and against autograd through the port's step-by-step
``ssd_sequential`` (the port sums the log-decay cum in f64, the reference
in f32, about 1e-5 apart in the forward at these sizes; measured at most
4.9e-6 here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssd import (ssd_chunk_bwd_kernel, ssd_chunk_bwd_plain,
                                     ssd_chunk_plain)

SWEEP = [                 # tests/test_kernels.py::test_ssd_kernel_sweep
    (1, 32, 2, 8, 4, 8),
    (2, 64, 4, 16, 8, 16),
    (1, 128, 2, 32, 16, 32),
    (2, 48, 3, 8, 8, 16),
]
REF = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _inputs(B, S, H, P, N, seed=0):
    """x, dt (post-softplus), A (negative), B_, C_ as f32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    B_ = rng.standard_normal((B, S, N)).astype(np.float32)
    C_ = rng.standard_normal((B, S, N)).astype(np.float32)
    return [x, dt, A, B_, C_]


def _cotangents(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _close_leaves(got, want, tol):
    """Each of the port's leaves finite and within ``tol`` of the
    reference's wherever the reference's is finite.  At the sweep's draw
    some chunk's decay can pass ~88, and then the reference's VJP is NaN
    for dt and A (ROADMAP queue 3): NaN is allowed there and nowhere
    else."""
    for name, g, w in zip(NAMES, got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w)
        assert np.isfinite(g).all(), name
        ok = np.isfinite(w)
        assert ok.all() or name in ("ddt", "dA"), name
        assert ok.any() and _rel(g[ok], w[ok]) <= tol, (name, _rel(g[ok], w[ok]))


def _sequential_grads(arrs, cts, h0=None):
    """Autograd through the step-by-step ``ssd_sequential``: an oracle with
    no chunks and no exp of a difference."""
    ins = _t(arrs + ([] if h0 is None else [h0]), grad=True)
    out = tref.ssd_sequential(*ins[:5], h0=None if h0 is None else ins[5])
    return [g.numpy() for g in torch.autograd.grad(out, ins, cts)]


def _ref_chunk_terms(x, dt, A, B_, C_, chunk):
    """The reference's ``ssd_chunk_terms`` over all chunks, in the layout of
    ``ssd_chunk_plain``."""
    Bsz, S, H, P = x.shape
    N, nc = B_.shape[-1], S // chunk
    y, st, dall, dch = rref.ssd_chunk_terms(
        x.reshape(Bsz * nc, chunk, H, P), dt.reshape(Bsz * nc, chunk, H), A,
        B_.reshape(Bsz * nc, chunk, N), C_.reshape(Bsz * nc, chunk, N))
    return (y.reshape(Bsz, S, H, P),
            st.reshape(Bsz, nc, H, P, N).swapaxes(1, 2),
            dall.reshape(Bsz, nc, H, chunk).swapaxes(1, 2),
            dch.reshape(Bsz, nc, H).swapaxes(1, 2))


@pytest.mark.parametrize("B,S,H,P,N,chunk", SWEEP)
def test_chunk_bwd_plain_matches_reference_vjp(B, S, H, P, N, chunk):
    arrs = _inputs(B, S, H, P, N, seed=10)
    nc = S // chunk
    cts = _cotangents([(B, S, H, P), (B, H, nc, P, N), (B, H, nc, chunk),
                       (B, H, nc)], seed=11)
    got = ssd_chunk_bwd_plain(*_t(arrs), *_t(cts), chunk=chunk)
    assert all(g.dtype == torch.float32 for g in got)
    _, vjp = jax.vjp(lambda *a: _ref_chunk_terms(*a, chunk), *_j(arrs))
    _close_leaves(got, vjp(tuple(_j(cts))), REF)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SWEEP)
def test_ops_ssd_grads_match_reference(B, S, H, P, N, chunk):
    """The scan's gradients against jax.vjp of ``ssd_reference`` and of the
    reference's own custom VJP ``ops.ssd`` (its Pallas forward in interpret
    mode, its backward through ``ssd_reference``)."""
    arrs = _inputs(B, S, H, P, N, seed=12)
    dy, dh = _cotangents([(B, S, H, P), (B, H, P, N)], seed=13)
    ins = _t(arrs, grad=True)
    y, h = tops.ssd(*ins, chunk)
    got = torch.autograd.grad((y, h), ins, (torch.from_numpy(dy),
                                            torch.from_numpy(dh)))
    cts = (jnp.asarray(dy), jnp.asarray(dh))
    _, vjp = jax.vjp(lambda *a: rref.ssd_reference(*a, chunk=chunk), *_j(arrs))
    _close_leaves(got, vjp(cts), REF)
    _, vjp = jax.vjp(lambda *a: rops.ssd(*a, chunk), *_j(arrs))
    _close_leaves(got, vjp(cts), REF)
    _close_leaves(got, _sequential_grads(arrs, (torch.from_numpy(dy),
                                                torch.from_numpy(dh))), REF)


def test_ops_ssd_dh0_matches_reference():
    B, S, H, P, N, chunk = 2, 64, 4, 16, 8, 16
    arrs = _inputs(B, S, H, P, N, seed=14)
    h0, dy, dh = _cotangents([(B, H, P, N), (B, S, H, P), (B, H, P, N)],
                             seed=15)
    ins = _t(arrs + [h0], grad=True)
    y, h = tops.ssd(*ins[:5], chunk, h0=ins[5])
    got = torch.autograd.grad((y, h), ins, (torch.from_numpy(dy),
                                            torch.from_numpy(dh)))
    _, vjp = jax.vjp(
        lambda x, dt, A, B_, C_, h0: rref.ssd_reference(x, dt, A, B_, C_,
                                                         chunk=chunk, h0=h0),
        *_j(arrs + [h0]))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    _close_leaves(got[:5], want[:5], REF)
    assert _rel(got[5].numpy(), want[5]) <= REF


def test_strong_decay_reference_grads_are_nan_and_the_ports_are_finite():
    """dt = 2 and A = (-1, -2) over a chunk of 64: above the diagonal
    cum_i - cum_j passes 88 and its exp is inf in f32.  The reference's VJP
    multiplies a zero cotangent by that inf and gives NaN for dt and A
    (ROADMAP queue 3); the port masks the log-decay before the exp, and
    its gradients are finite and match autograd through the step-by-step
    ``ssd_sequential``."""
    B, S, H, P, N, chunk = 1, 64, 2, 4, 4, 64
    rng = np.random.default_rng(16)
    arrs = [rng.standard_normal((B, S, H, P)).astype(np.float32),
            np.full((B, S, H), 2.0, np.float32),
            np.array([-1.0, -2.0], np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32)]
    dy, dh = _cotangents([(B, S, H, P), (B, H, P, N)], seed=17)
    _, vjp = jax.vjp(lambda *a: rref.ssd_reference(*a, chunk=chunk), *_j(arrs))
    ref = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    assert np.isnan(np.asarray(ref[1])).any() and np.isnan(np.asarray(ref[2])).any()
    assert all(np.isfinite(np.asarray(ref[i])).all() for i in (0, 3, 4))
    cts = (torch.from_numpy(dy), torch.from_numpy(dh))
    ins = _t(arrs, grad=True)
    got = torch.autograd.grad(tops.ssd(*ins, chunk), ins, cts)
    _close_leaves(got, _sequential_grads(arrs, cts), REF)


def _unmasked_chunk_terms(xc, dtc, A, Bc, Cc):
    """``ssd_chunk_terms`` with a single select after the exp (the
    reference's form), in the port's f64 cum."""
    Q = xc.shape[1]
    Li = torch.cumsum((dtc * A[None, None, :]).double(), dim=1).transpose(1, 2)
    diff = (Li[:, :, :, None] - Li[:, :, None, :]).float()
    mask = torch.ones((Q, Q), dtype=torch.bool).tril()
    L = torch.where(mask, torch.exp(diff), 0.0)
    cb = torch.einsum("bin,bjn->bij", Cc, Bc)
    M = cb[:, None] * L * dtc.transpose(1, 2)[:, :, None, :]
    y_intra = torch.einsum("bhij,bjhp->bihp", M, xc)
    decay_to_end = torch.exp((Li[:, :, -1:] - Li).float())
    w = (decay_to_end * dtc.transpose(1, 2)).transpose(1, 2)
    state = torch.einsum("bqhp,bqn->bhpn", xc * w[..., None], Bc)
    return (y_intra, state, torch.exp(Li.float()),
            torch.exp(Li[:, :, -1].float()))


@pytest.mark.parametrize("B,S,H,P,N,chunk", SWEEP)
def test_masked_chunk_terms_forward_is_bitwise_unchanged(B, S, H, P, N, chunk):
    x, dt, A, B_, C_ = (a[:, :chunk] if a.ndim > 1 else a
                        for a in _t(_inputs(B, S, H, P, N, seed=18)))
    for got, want in zip(tref.ssd_chunk_terms(x, dt, A, B_, C_),
                         _unmasked_chunk_terms(x, dt, A, B_, C_)):
        assert torch.equal(got, want)


def test_grad_path_forward_equals_the_forward_only_path():
    """``ops.ssd``'s outputs with inputs that require grad are bitwise
    those of the same call under no_grad (the serving path)."""
    arrs = _inputs(2, 64, 4, 16, 8, seed=19)
    with torch.no_grad():
        y0, h0 = tops.ssd(*_t(arrs), 16)
    y1, h1 = tops.ssd(*_t(arrs, grad=True), 16)
    assert y1.requires_grad and torch.equal(y0, y1.detach())
    assert torch.equal(h0, h1.detach())


def test_bf16_inputs_get_grads_in_their_own_type():
    """x, B_ and C_ in bf16 (split views of one tensor, as the model hands
    them over): each gradient comes back in its input's type, the f32
    gradients of the same rounded values rounded once."""
    B, S, H, P, N, chunk = 1, 32, 2, 8, 4, 8
    rng = np.random.default_rng(20)
    xBC = torch.from_numpy(rng.standard_normal((B, S, H * P + 2 * N))
                           .astype(np.float32)).bfloat16().requires_grad_()
    x = xBC[..., :H * P].reshape(B, S, H, P)
    B_, C_ = xBC[..., H * P:H * P + N], xBC[..., H * P + N:]
    _, dt, A, _, _ = _t(_inputs(B, S, H, P, N, seed=21))
    dt.requires_grad_()
    A.requires_grad_()
    dy = torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(np.float32))
    y, h = tops.ssd(x, dt, A, B_, C_, chunk)
    assert y.dtype == torch.bfloat16
    gxbc, gdt, gA = torch.autograd.grad(y.float(), (xBC, dt, A), dy)
    assert gxbc.dtype == torch.bfloat16 and gdt.dtype == gA.dtype == torch.float32
    ins = [t.detach().float().requires_grad_() for t in (xBC, dt, A)]
    x32 = ins[0][..., :H * P].reshape(B, S, H, P)
    y32, _ = tops.ssd(x32, ins[1], ins[2], ins[0][..., H * P:H * P + N],
                      ins[0][..., H * P + N:], chunk)
    want = torch.autograd.grad(y32, ins, dy.bfloat16().float())
    assert _rel(gdt.numpy(), want[1].numpy()) <= 1e-2      # y rounds to bf16
    assert _rel(gxbc.float().numpy(), want[0].numpy()) <= 1e-2


def test_plain_bwd_rounds_dx_once_to_x_type():
    """K2b's contract, held by its plain version: dx in x's type, the f32
    sum of the same inputs upcast (exactly) rounded once; the other four
    gradients f32 and bitwise those of the upcast inputs."""
    B, S, H, P, N, chunk = 1, 32, 2, 8, 4, 8
    x, dt, A, B_, C_ = _t(_inputs(B, S, H, P, N, seed=24))
    cts = _t(_cotangents([(B, S, H, P), (B, H, S // chunk, P, N),
                          (B, H, S // chunk, chunk), (B, H, S // chunk)],
                         seed=25))
    args = (x.bfloat16(), dt, A, B_.bfloat16(), C_.bfloat16())
    got = ssd_chunk_bwd_plain(*args, *cts, chunk=chunk)
    want = ssd_chunk_bwd_plain(*(t.float() for t in args), *cts, chunk=chunk)
    assert got[0].dtype == torch.bfloat16
    assert torch.equal(got[0], want[0].bfloat16())
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32 and torch.equal(g, w)


def test_bwd_kernel_wrapper_refuses_cpu_tensors():
    arrs = _t(_inputs(1, 32, 2, 8, 4))
    cts = _t(_cotangents([(1, 32, 2, 8), (1, 2, 4, 8, 4), (1, 2, 4, 8),
                          (1, 2, 4)], seed=22))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_chunk_bwd_kernel(*arrs, *cts, chunk=8)


def test_ops_ssd_chunk_grads_routes_cpu_to_plain():
    arrs = _t(_inputs(1, 32, 2, 8, 4))
    cts = _t(_cotangents([(1, 32, 2, 8), (1, 2, 4, 8, 4), (1, 2, 4, 8),
                          (1, 2, 4)], seed=23))
    before = ssd_chunk_bwd_kernel.launches
    for got, want in zip(tops.ssd_chunk_grads(*arrs, *cts, chunk=8),
                         ssd_chunk_bwd_plain(*arrs, *cts, chunk=8)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert ssd_chunk_bwd_kernel.launches == before
    # the four terms it differentiates are ssd_chunk_plain's
    assert len(ssd_chunk_plain(*arrs, chunk=8)) == len(cts)
