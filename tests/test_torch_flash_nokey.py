"""Rows that see no key: the contract of the flash kernels' plain versions.

With Sq > Skv and a sliding window, a q row past Skv + window - 1 sees no
key at all.  The reference gives no single answer for such a row (its dense
``attention_reference`` the mean of v, its blockwise version a mean that
depends on the block size, its VJP p = 1 on every masked entry), so the
port's plain versions of K1 and K1b (``flash_attention_plain``,
``flash_attention_lse_plain``, ``flash_attention_bwd_plain``) give it what
FlashAttention kernels give: o = 0, lse = -1e30, and no gradient.

On every row that sees a key they still match the reference at 5e-5 (atol
and rtol, the reference's own tolerance for its VJP): the forward against
``attention_reference``, the gradients against ``jax.vjp`` of
``blockwise_attention`` with do zeroed on the rows that see no key, so that
the reference's p = 1 there adds nothing to dv.  Shape B=1, Sq=96, Skv=32,
Hq=2, Hkv=1, D=16, causal, window 13, f32, with and without a cap of 30.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import attention_reference as ref_attention
from repro.models import attention as RA
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (NEG_INF, attention_reference,
                                     flash_attention_lse_plain,
                                     flash_attention_plain)

TOL = 5e-5
B, SQ, SKV, HQ, HKV, D, WINDOW = 1, 96, 32, 2, 1, 16, 13
# row i sees a key when some kv < Skv has i - window < kv <= i
SEEN = SKV + WINDOW - 1             # rows 0 .. SEEN-1 see a key


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, SQ, HQ, D), (B, SKV, HKV, D), (B, SKV, HKV, D),
                      (B, SQ, HQ, D))]


def _port_grads(q, k, v, do, cap):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ops.blockwise_attention(*leaves, 0, True, WINDOW, cap)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    return [g.numpy() for g in grads]


def test_rows_that_see_no_key_are_the_ones_expected():
    s = np.arange(SQ)[:, None]
    kv = np.arange(SKV)[None, :]
    seen = ((kv <= s) & (kv > s - WINDOW)).any(-1)
    assert seen[:SEEN].all() and not seen[SEEN:].any()


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_plain_forward_matches_reference_on_rows_with_a_key(cap):
    q, k, v, _ = _inputs(seed=1)
    want = np.asarray(ref_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                    causal=True, window=WINDOW,
                                    attn_softcap=cap))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(causal=True, window=WINDOW, attn_softcap=cap)
    for got in (flash_attention_plain(tq, tk, tv, **kw),
                flash_attention_lse_plain(tq, tk, tv, **kw)[0]):
        np.testing.assert_allclose(got.numpy()[:, :SEEN], want[:, :SEEN],
                                   atol=TOL, rtol=TOL)
    # the port's copy of attention_reference stays the reference's on
    # every row, the mean of v included
    np.testing.assert_allclose(attention_reference(tq, tk, tv, **kw).numpy(),
                               want, atol=TOL, rtol=TOL)


def test_reference_gives_rows_without_a_key_the_mean_of_v():
    """The reference's defect that the port does not copy: its dense
    attention gives such a row the mean of v over all the keys."""
    q, k, v, _ = _inputs(seed=4)
    o = np.asarray(ref_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                 causal=True, window=WINDOW))
    mean_v = v.mean(axis=1)[:, None, :, :]          # (B, 1, Hkv, D)
    np.testing.assert_allclose(o[:, SEEN:],
                               np.broadcast_to(mean_v, o[:, SEEN:].shape),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_plain_grads_match_reference_vjp_on_rows_with_a_key(cap):
    q, k, v, do = _inputs(seed=2)
    do[:, SEEN:] = 0.0
    zero = jnp.zeros((), jnp.int32)
    _, vjp = jax.vjp(lambda q_, k_, v_: RA.blockwise_attention(
        q_, k_, v_, zero, True, WINDOW, cap, 16, 16),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    got = _port_grads(q, k, v, do, cap)
    np.testing.assert_allclose(got[0][:, :SEEN], want[0][:, :SEEN], atol=TOL,
                               rtol=TOL, err_msg="dq")
    for name, g, w in zip(("dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_rows_without_a_key_give_zero_and_no_gradient(cap):
    q, k, v, do = _inputs(seed=3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(causal=True, window=WINDOW, attn_softcap=cap)
    o, lse = flash_attention_lse_plain(tq, tk, tv, **kw)
    assert bool((o[:, SEEN:] == 0).all())
    assert bool((flash_attention_plain(tq, tk, tv, **kw)[:, SEEN:] == 0).all())
    assert bool((lse[:, SEEN:] == torch.tensor(NEG_INF)).all())
    assert bool((lse[:, :SEEN] > -1e3).all())
    # a nonzero do on those rows changes neither dk nor dv, and their dq is 0
    quiet = do.copy()
    quiet[:, SEEN:] = 0.0
    loud = _port_grads(q, k, v, do, cap)
    calm = _port_grads(q, k, v, quiet, cap)
    assert np.abs(do[:, SEEN:]).max() > 0
    np.testing.assert_array_equal(loud[1], calm[1])
    np.testing.assert_array_equal(loud[2], calm[2])
    assert (loud[0][:, SEEN:] == 0).all()
    np.testing.assert_array_equal(loud[0][:, :SEEN], calm[0][:, :SEEN])
