"""The recurrence between the SSD chunks (K3's and K3b's plain versions,
``ops.ssd_pass``, ``ops.ssd_pass_grads`` and ``ops._SSDPass``) on the CPU.

* ``ssd_pass_plain`` is the loop over chunks ``ops.ssd`` ran before the
  recurrence became one function: the same ops, so bitwise the same y and
  final state.
* ``ssd_pass_bwd_plain``, the reverse scan K3b runs, equals
  ``torch.autograd.grad`` of that loop in f64 (1e-12: the same sums in
  another order), with h0 given or absent and dhT nonzero or absent.
* ``ops.ssd``'s gradients through ``_SSDPass`` equal autograd through the
  loop in f32 (1e-5 of each gradient's largest magnitude: f32 sums in
  another order); its output matches the reference's ``ssd_reference`` and
  ``ops.ssd`` at the repo's f32 tolerance, 3e-5.
* The wrappers refuse CPU tensors; the route rule; the meta route's
  shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (inter_chunk_y, ssd_chunk_plain,
                                     ssd_pass_bwd_plain, ssd_pass_plain)
from repro_torch.kernels.ssd_pass import (pass_route, ssd_pass_bwd_kernel,
                                          ssd_pass_kernel)

SHAPES = [(1, 32, 2, 8, 4, 8), (2, 64, 4, 16, 8, 16), (2, 48, 3, 8, 8, 16),
          (1, 16, 2, 4, 4, 16)]           # (B, S, H, P, N, chunk); one chunk
F32_TOL = 3e-5


def _terms(B, S, H, P, N, Q, seed, dtype=torch.float32):
    """K2's four terms (plain), C_ and h0 from a numpy seed."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    x, B_, C_ = f(B, S, H, P), f(B, S, N), f(B, S, N)
    dt = torch.from_numpy(np.logaddexp(rng.standard_normal((B, S, H)), 0)
                          .astype(np.float32))
    A = -torch.from_numpy(np.exp(rng.standard_normal(H) * 0.5)
                          .astype(np.float32))
    terms = ssd_chunk_plain(x, dt, A, B_, C_, chunk=Q)
    return [t.to(dtype) for t in terms], C_.to(dtype), f(B, H, P, N).to(dtype)


def _loop(y_intra, states, dall, dchunk, C_, h0, dtype):
    """The recurrence as ``ops.ssd`` ran it, a loop over chunks of plain
    ops differentiated by autograd."""
    Bsz, S, H, P = y_intra.shape
    N = C_.shape[-1]
    nc = states.shape[2]
    Cr = C_.to(states.dtype).reshape(Bsz, nc, S // nc, N)
    h = (torch.zeros((Bsz, H, P, N), dtype=states.dtype) if h0 is None
         else h0)
    y_inter = []
    for c in range(nc):
        y_inter.append(inter_chunk_y(Cr[:, c], dall[:, :, c], h))
        h = h * dchunk[:, :, c, None, None] + states[:, :, c]
    y_inter = torch.stack(y_inter, dim=1).view(Bsz, S, H, P)
    return (y_intra + y_inter).to(dtype), h


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_pass_plain_is_the_loop(shape, with_h0):
    terms, C_, h0 = _terms(*shape, seed=0)
    h0 = h0 if with_h0 else None
    y, hT, h_prev = ssd_pass_plain(*terms, C_, h0, dtype=torch.float32)
    wy, whT = _loop(*terms, C_, h0, torch.float32)
    assert torch.equal(y, wy) and torch.equal(hT, whT)
    B, S, H, P, N, Q = shape
    assert h_prev.shape == (B, H, S // Q, P, N)
    assert torch.equal(h_prev[:, :, 0], torch.zeros_like(hT) if h0 is None
                       else h0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("with_dhT", [False, True])
def test_pass_bwd_plain_is_autograd_of_the_loop(shape, with_h0, with_dhT):
    """In f64: d y_intra, d states, d decay_all, d decay_chunk, dC and dh0
    of the reverse scan against autograd through the loop."""
    f64 = torch.float64
    terms, C_, h0 = _terms(*shape, seed=1, dtype=f64)
    ins = [t.detach().requires_grad_() for t in (*terms, C_)]
    h0 = h0.requires_grad_() if with_h0 else None
    y, hT = _loop(*ins, h0, f64)
    rng = np.random.default_rng(2)
    dy = torch.from_numpy(rng.standard_normal(y.shape))
    dhT = torch.from_numpy(rng.standard_normal(hT.shape)) if with_dhT else None
    wrt = ins + ([h0] if with_h0 else [])
    want = torch.autograd.grad((y, hT), wrt, (dy, dhT if with_dhT
                                              else torch.zeros_like(hT)))
    _, _, h_prev = ssd_pass_plain(*terms, C_, None if h0 is None
                                  else h0.detach(), dtype=f64)
    got = ssd_pass_bwd_plain(dy, dhT, h_prev, terms[2], terms[3], C_)
    assert all(g.dtype == f64 for g in got)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-12 * max(1.0, float(
            w.abs().max()))


def _ssd_inputs(B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    B_ = rng.standard_normal((B, S, N)).astype(np.float32)
    C_ = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A, B_, C_


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("with_dhT", [False, True])
def test_ops_ssd_grads_equal_autograd_through_the_loop(with_h0, with_dhT):
    B, S, H, P, N, Q = 2, 64, 4, 16, 8, 16
    rng = np.random.default_rng(3)
    ins = [torch.from_numpy(a).requires_grad_()
           for a in _ssd_inputs(B, S, H, P, N, seed=4)]
    h0 = (torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(
        np.float32)).requires_grad_() if with_h0 else None)
    wrt = ins + ([h0] if with_h0 else [])
    y, hT = ops.ssd(*ins, Q, h0=h0)
    dy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    dhT = torch.from_numpy(rng.standard_normal(hT.shape).astype(np.float32))
    outs, cts = ((y, hT), (dy, dhT)) if with_dhT else ((y,), (dy,))
    got = torch.autograd.grad(outs, wrt, cts)
    terms = ops._SSDChunk.apply(*ins, Q)
    wy, whT = _loop(*terms, ins[4], h0, torch.float32)
    assert torch.equal(y, wy) and torch.equal(hT, whT)
    want = torch.autograd.grad((wy, whT) if with_dhT else (wy,), wrt, cts)
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-5 * scale


def test_ops_ssd_only_the_final_state_reaches_the_loss():
    """The state alone downstream: y's cotangent is absent, and the
    gradients still match the loop's."""
    B, S, H, P, N, Q = 1, 32, 2, 8, 4, 8
    ins = [torch.from_numpy(a).requires_grad_()
           for a in _ssd_inputs(B, S, H, P, N, seed=5)]
    _, hT = ops.ssd(*ins, Q)
    got = torch.autograd.grad(hT.square().sum(), ins)
    _, whT = _loop(*ops._SSDChunk.apply(*ins, Q), ins[4], None,
                   torch.float32)
    want = torch.autograd.grad(whT.square().sum(), ins, allow_unused=True)
    for g, w in zip(got, want):
        w = torch.zeros_like(g) if w is None else w
        assert float((g - w).abs().max()) <= 1e-5 * max(
            1.0, float(w.abs().max()))


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES[:3])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ops_ssd_cpu_route_matches_the_reference(B, S, H, P, N, chunk,
                                                 with_h0):
    arrs = _ssd_inputs(B, S, H, P, N, seed=6)
    h0 = (np.random.default_rng(7).standard_normal((B, H, P, N))
          .astype(np.float32) if with_h0 else None)
    y, h = ops.ssd(*(torch.from_numpy(a) for a in arrs), chunk,
                   h0=None if h0 is None else torch.from_numpy(h0))
    j = [jnp.asarray(a) for a in arrs]
    wants = [rref.ssd_reference(*j, chunk=chunk,
                                h0=None if h0 is None else jnp.asarray(h0))]
    if h0 is None:
        wants.append(rops.ssd(*j, chunk))     # interpret mode on the CPU
    for wy, wh in wants:
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=F32_TOL,
                                   rtol=F32_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(wh), atol=F32_TOL,
                                   rtol=F32_TOL)


def test_pass_kernel_wrappers_refuse_cpu_tensors():
    terms, C_, _ = _terms(1, 32, 2, 8, 4, 8, seed=8)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_pass_kernel(*terms, C_, dtype=torch.float32)
    h_prev = torch.zeros_like(terms[1])
    with pytest.raises(ValueError, match="CUDA"):
        ssd_pass_bwd_kernel(terms[0], None, h_prev, terms[2], terms[3], C_,
                            with_dh0=False)


@pytest.mark.parametrize("dtype,P,N,route", [
    (torch.bfloat16, 64, 128, "mma"), (torch.bfloat16, 128, 128, "mma"),
    (torch.bfloat16, 64, 16, "mma"), (torch.bfloat16, 64, 256, "f32"),
    (torch.bfloat16, 32, 128, "f32"), (torch.bfloat16, 64, 12, "f32"),
    (torch.float32, 64, 128, "f32")])
def test_pass_route_by_shape_and_type(dtype, P, N, route):
    assert pass_route(torch.zeros((1, 8, N), dtype=dtype), P) == route


def test_ops_ssd_on_meta_gives_the_shapes():
    B, S, H, P, N, Q = 2, 64, 4, 16, 8, 16
    m = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt, device="meta")
    y, hT = ops.ssd(m(B, S, H, P), m(B, S, H, dt=torch.float32),
                    m(H, dt=torch.float32), m(B, S, N), m(B, S, N), Q)
    assert (y.shape, y.dtype) == ((B, S, H, P), torch.bfloat16)
    assert (hT.shape, hT.dtype) == ((B, H, P, N), torch.float32)
