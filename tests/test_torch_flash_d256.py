"""Port parity at head dim 256 (gemma2-9b's), on the CPU.

The port's K1 and K1b take D=256 (``HEAD_DIMS``); on CPU tensors their
wrappers' callers take the plain versions, which are held here against the
reference at that head dim: the forward against the reference's Pallas
kernel (``repro.kernels.ops.flash_attention``, interpret mode) and the lse
of its ``_flash_fwd``; the backward, through the port's differentiable
``blockwise_attention``, against ``jax.vjp`` of the reference's
``blockwise_attention``.  Small B and S, with and without gemma2's window
and attention cap; lengths that are not multiples of the card kernels'
64- and 128-row tiles, and Sq != Skv, as the card's tests use them (every
row sees a key: the reference gives a row that sees none a value that
depends on its block size).  Tolerances: the forward's f32 3e-5 and bf16 3e-2
(tests/test_kernels.py), the backward's f32 5e-5 (the reference's own VJP
tolerance).  The CUDA kernels at D=256 are held against these plain
versions on a card (tests/test_torch_gpu.py, chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.models import attention as RA
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.kernels.ref import flash_attention_lse_plain
from repro_torch.models import attention as TA

D = 256
TOL = {"float32": 3e-5, "bfloat16": 3e-2}
BWD_TOL = 5e-5
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SHAPES = [(1, 40, 40, 4, 2), (2, 33, 33, 2, 1),   # (B, Sq, Skv, Hq, Hkv)
          (1, 200, 200, 2, 1), (1, 257, 257, 2, 2), (1, 300, 290, 2, 1),
          (1, 200, 300, 4, 2)]
WINDOW_CAP = [(0, 0.0), (13, 50.0)]              # gemma2: cap 50


def _inputs(B, Sq, Skv, Hq, Hkv, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D),
                      (B, Sq, Hq, D))]


def _seed(shape):
    """The sum of (B, Sq, Hq, Hkv): the first shapes' seeds of old."""
    return sum(shape) - shape[2]


def test_head_dim_256_is_taken():
    assert D in HEAD_DIMS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,cap", WINDOW_CAP)
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_d256_matches_reference_kernel(shape, window, cap, dtype):
    q, k, v, _ = _inputs(*shape, seed=_seed(shape) + window)
    got = tops.flash_attention(
        *(torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v)),
        causal=True, window=window, attn_softcap=cap)
    want = rops.flash_attention(*(jnp.asarray(a, JDT[dtype])
                                  for a in (q, k, v)),
                                causal=True, window=window, attn_softcap=cap)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("window,cap", WINDOW_CAP)
@pytest.mark.parametrize("shape", SHAPES)
def test_lse_and_grads_d256_match_reference_vjp(shape, window, cap):
    q, k, v, do = _inputs(*shape, seed=7 * _seed(shape) + window)
    B, Sq, _, Hq, _ = shape
    zero = jnp.zeros((), jnp.int32)
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    want_o, vjp = jax.vjp(lambda q_, k_, v_: RA.blockwise_attention(
        q_, k_, v_, zero, True, window, cap, 16, 16), *jargs)
    want_grads = vjp(jnp.asarray(do))
    _, (_, _, _, _, _, want_lse) = RA._flash_fwd(*jargs, zero, True, window,
                                                 cap, 16, 16)

    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = TA.blockwise_attention(*leaves, 0, True, window, cap)
    grads = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    _, lse = flash_attention_lse_plain(*(t.detach() for t in leaves),
                                       causal=True, window=window,
                                       attn_softcap=cap)
    for name, g, w, tol in (
            ("o", o.detach(), want_o, TOL["float32"]),
            ("lse", lse, np.asarray(want_lse).reshape(B, Sq, Hq),
             TOL["float32"]),
            *((n, g, w, BWD_TOL) for n, g, w in zip(("dq", "dk", "dv"),
                                                    grads, want_grads))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                   rtol=tol, err_msg=name)
