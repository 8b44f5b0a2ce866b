"""Port parity: repro_torch.models.layers against repro.models.layers.

The same numpy inputs go through both packages on the CPU.  Tolerances:
f32 1e-5 (same arithmetic, other summation order); bf16 3e-2 (the
reference's own bf16 tolerance, tests/test_kernels.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.models import layers as TL

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a, dtype):
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    w = rng.standard_normal((48,)).astype(np.float32) * 0.1
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(w, dtype)
    _close(TL.rms_norm(tx, tw, 1e-6), RL.rms_norm(jx, jw, 1e-6), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [0.0, 5.0])
def test_softcap(dtype, cap):
    x = np.random.default_rng(1).standard_normal((4, 33)).astype(np.float32) * 10
    jx, tx = _pair(x, dtype)
    _close(TL.softcap(tx, cap), RL.softcap(jx, cap), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_interleaved(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 7))
    jx, tx = _pair(x, dtype)
    got = TL.apply_rope(tx, torch.from_numpy(pos), 10_000.0)
    want = RL.apply_rope(jx, jnp.asarray(pos), 10_000.0)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gated", [True, False])
def test_mlp(dtype, gated):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("wi", (32, 64)), ("wg", (32, 64)), ("wo", (64, 32)))}
    jx, tx = _pair(x, dtype)
    jw = {n: _pair(a, dtype)[0] for n, a in w.items()}
    tw = {n: _pair(a, dtype)[1] for n, a in w.items()}
    _close(TL.mlp(tx, tw, gated), RL.mlp(jx, jw, gated), dtype)
