"""Port parity for attention: ops.flash_attention and decode_attention.

On the CPU the port's ``ops.flash_attention`` takes the kernel's plain
version; it is held against the reference's Pallas kernel (interpret mode)
and its ``attention_reference`` over the grid of
``tests/test_kernels.py::test_flash_kernel_sweep``.  Tolerances are that
test's: f32 3e-5, bf16 3e-2.  The CUDA kernel itself is held against its
plain version on a card by ``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels.ref import attention_reference as r_attention
from repro.models.attention import decode_attention as r_decode
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.models.attention import decode_attention as t_decode

TOL = {"float32": 3e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SHAPES = [
    (1, 32, 2, 2, 16),
    (2, 64, 4, 2, 32),
    (1, 100, 8, 8, 64),      # ragged seq (padding path)
    (2, 96, 6, 3, 16),
    (1, 128, 16, 4, 64),     # deep GQA
]
WINDOW_CAP = [(0, 0.0), (13, 0.0), (0, 30.0), (13, 30.0)]


def _qkv(B, S, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, Hq, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32))


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("B,Sq,Hq,Hkv,D", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,cap", WINDOW_CAP)
def test_flash_attention_matches_reference(B, Sq, Hq, Hkv, D, dtype, window,
                                           cap):
    arrs = _qkv(B, Sq, Hq, Hkv, D)
    jq, jk, jv = (jnp.asarray(a, JDT[dtype]) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a).to(TDT[dtype]) for a in arrs)
    got = tops.flash_attention(tq, tk, tv, causal=True, window=window,
                               attn_softcap=cap).float().numpy()
    kernel = rops.flash_attention(jq, jk, jv, causal=True, window=window,
                                  attn_softcap=cap)
    plain = r_attention(jq, jk, jv, causal=True, window=window,
                        attn_softcap=cap)
    _close(got, kernel, dtype)
    _close(got, plain, dtype)


def test_flash_attention_smollm_heads():
    """smollm-360m's head layout: 15 q heads on 5 kv heads, head_dim 64."""
    arrs = _qkv(2, 40, 15, 5, 64, seed=1)
    got = tops.flash_attention(*(torch.from_numpy(a) for a in arrs))
    want = rops.flash_attention(*(jnp.asarray(a) for a in arrs))
    _close(got.numpy(), want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (5, 20.0)])
def test_decode_attention(dtype, window, cap):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 1, 6, 32)).astype(np.float32)
    kc = rng.standard_normal((3, 24, 2, 32)).astype(np.float32)
    vc = rng.standard_normal((3, 24, 2, 32)).astype(np.float32)
    for pos in (0, 9, 23):
        got = t_decode(*(torch.from_numpy(a).to(TDT[dtype]) for a in (q, kc, vc)),
                       pos, window=window, attn_softcap=cap)
        want = r_decode(*(jnp.asarray(a, JDT[dtype]) for a in (q, kc, vc)),
                        jnp.int32(pos), window=window, attn_softcap=cap)
        _close(got.float().numpy(), want, dtype)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 2, 1, 16))
    before = flash_attention_fwd.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_fwd(q, k, v)
    assert flash_attention_fwd.launches == before


def test_launch_counts_survive_concurrent_launches():
    """Pilot tasks launch kernels from several agent threads at once (a
    train segment beside an evaluation): no count may be lost."""
    import sys
    import threading

    from repro_torch.kernels import _build

    def wrapper():
        pass
    wrapper.launches = 0
    n_threads, n_each = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count_launch(wrapper) for _ in range(n_each)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == n_threads * n_each
