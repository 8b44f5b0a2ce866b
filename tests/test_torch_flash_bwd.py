"""Port parity for training attention: ``ops.blockwise_attention``.

On CPU tensors the port's differentiable attention runs the plain versions
of K1 (with its lse) and K1b (``flash_attention_lse_plain``,
``flash_attention_bwd_plain``).  Both are held against the reference's
``blockwise_attention``: its output, the lse of ``_flash_fwd`` and the
gradients of its custom VJP (``_flash_bwd``) by ``jax.vjp``, on the same
numpy inputs in f32.  Tolerance 5e-5 (atol and rtol), the reference's own
for its VJP (``test_flash_vjp_matches_reference_grads``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:                      # fall back to the vendored shim
    from _propshim import given, settings, st

from repro.kernels.ref import attention_reference as ref_attention
from repro.models import attention as RA
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (flash_attention_bwd_plain,
                                     flash_attention_lse_plain)
from repro_torch.models import attention as TA

TOL = 5e-5
SWEEP = [(1, 32, 2, 2, 16), (2, 64, 4, 2, 32), (1, 100, 8, 8, 64),
         (2, 96, 6, 3, 16), (1, 128, 16, 4, 64)]   # tests/test_kernels.py
WINDOW_CAP = [(0, 0.0), (13, 0.0), (0, 30.0), (13, 30.0)]


def _inputs(B, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D),
                      (B, S, Hq, D))]


def _reference(q, k, v, do, window, cap, block=16):
    """Output, lse and (dq, dk, dv) of the reference's blockwise attention."""
    zero = jnp.zeros((), jnp.int32)
    args = [jnp.asarray(a) for a in (q, k, v)]
    out, vjp = jax.vjp(lambda q_, k_, v_: RA.blockwise_attention(
        q_, k_, v_, zero, True, window, cap, block, block), *args)
    grads = vjp(jnp.asarray(do))
    _, (_, _, _, _, _, lse) = RA._flash_fwd(*args, zero, True, window, cap,
                                            block, block)
    B, S, Hq, _ = q.shape
    return ([np.asarray(out), np.asarray(lse).reshape(B, S, Hq)]
            + [np.asarray(g) for g in grads])


def _port(q, k, v, do, window, cap):
    q_, k_, v_ = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = TA.blockwise_attention(q_, k_, v_, 0, True, window, cap)
    grads = torch.autograd.grad(out, (q_, k_, v_), torch.from_numpy(do))
    _, lse = flash_attention_lse_plain(q_.detach(), k_.detach(), v_.detach(),
                                       causal=True, window=window,
                                       attn_softcap=cap)
    return [out.detach().numpy(), lse.numpy()] + [g.numpy() for g in grads]


def _close(got, want, names=("o", "lse", "dq", "dk", "dv"), tol=TOL):
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("window,cap", WINDOW_CAP)
@pytest.mark.parametrize("shape", SWEEP)
def test_blockwise_attention_matches_reference_sweep(shape, window, cap):
    q, k, v, do = _inputs(*shape, seed=sum(shape) + window)
    _close(_port(q, k, v, do, window, cap),
           _reference(q, k, v, do, window, cap, block=32))


@pytest.mark.parametrize("window,cap", [(0, 0.0), (11, 20.0)])
def test_blockwise_grads_match_reference_vjp_shapes(window, cap):
    """The shapes and window/cap pairs of the reference's
    test_flash_vjp_matches_reference_grads, also against the gradients of
    its dense ``attention_reference``."""
    q, k, v, do = _inputs(2, 40, 6, 3, 16, seed=window)
    got = _port(q, k, v, do, window, cap)
    _close(got, _reference(q, k, v, do, window, cap))
    dense = jax.grad(lambda q_, k_, v_: (ref_attention(
        q_, k_, v_, causal=True, window=window, attn_softcap=cap)
        * jnp.asarray(do)).sum(), argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in (q, k, v)))
    _close(got[2:], [np.asarray(g) for g in dense], names=("dq", "dk", "dv"))


def test_plain_backward_equals_autograd_of_the_plain_forward():
    """flash_attention_bwd_plain against torch autograd through
    flash_attention_lse_plain: the formulas of the backward."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 33, 6, 2, 16,
                                                          seed=3))
    for window, cap in WINDOW_CAP:
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o, lse = flash_attention_lse_plain(*leaves, causal=True,
                                           window=window, attn_softcap=cap)
        want = torch.autograd.grad(o, leaves, do)
        got = flash_attention_bwd_plain(q, k, v, o.detach(), lse.detach(), do,
                                        causal=True, window=window,
                                        attn_softcap=cap)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL,
                                       rtol=TOL)


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 2), st.integers(1, 40), st.integers(1, 3),
       st.integers(1, 2), st.sampled_from([8, 16]),
       st.sampled_from([0, 5]), st.integers(0, 10_000))
def test_blockwise_attention_property(b, s, g, hkv, d, window, seed):
    """Port == reference for random shapes, windows and block sizes of the
    reference (property, after test_flash_blockwise_invariance)."""
    q, k, v, do = _inputs(b, s, g * hkv, hkv, d, seed)
    block = int(np.random.default_rng(seed).integers(1, 25))
    _close(_port(q, k, v, do, window, 0.0),
           _reference(q, k, v, do, window, 0.0, block=block))


def test_q_offset_raises():
    """A negative q_offset has no position to give q's rows: it raises.  A
    positive one is the sequence-parallel chunk's start and runs
    (tests/test_torch_sharding.py holds it against the reference)."""
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="q_offset"):
        ops.blockwise_attention(q, q, q, -1)
    assert ops.blockwise_attention(q, q, q, 3).shape == q.shape
