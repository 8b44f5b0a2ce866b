"""Port parity for the Mamba2 model: reduced mamba2-1.3b in f32 on the CPU.

The reference's ``T.init_params`` is converted through numpy into the
port's layout (``repro_torch.params``), and the same tokens go through both
packages.  The reference runs its ``ssd_reference`` route
(``use_pallas=False``): its Pallas route through the model raises a
TypeError (ROADMAP queue 3), and ``tests/test_torch_ssd.py`` holds the
port's SSD against the reference's ``ops.ssd`` directly.  Tolerance 1e-4
on logits, layer outputs and caches: the same f32 arithmetic in another
summation order, through two layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import mamba2 as RM2
from repro.models import model as RM
from repro.models import transformer as RT
from repro.sharding.partition import NULL_CTX
from repro_torch import configs as TC
from repro_torch import params as P
from repro_torch.models import mamba2 as TM2
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT

ARCH = "mamba2-1.3b"
TOL = 1e-4


def _cfg(dtype="float32"):
    return dataclasses.replace(RC.reduce_config(RC.get_config(ARCH)), dtype=dtype)


def _tcfg(dtype="float32"):
    return dataclasses.replace(TC.reduce_config(TC.get_config(ARCH)), dtype=dtype)


def _params(cfg, seed=0):
    tree = jax.tree.map(np.asarray, RT.init_params(cfg, jax.random.PRNGKey(seed)))
    return tree, P.from_numpy_tree(tree, device="cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _cache_np(cfg, B, seed):
    """A random decode cache in the reference's stacked layout, as numpy."""
    rng = np.random.default_rng(seed)
    spec = RT.cache_specs(cfg, B, 16, "float32")
    return [tuple(rng.standard_normal(s.shape).astype(np.float32) for s in c)
            for c in spec]


@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv_matches_reference(with_prev):
    rng = np.random.default_rng(0)
    B, S, C, W = 2, 7, 24, 4
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    w = rng.standard_normal((W, C)).astype(np.float32)
    prev = rng.standard_normal((B, W - 1, C)).astype(np.float32) if with_prev else None
    got, tail = TM2._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                 None if prev is None else torch.from_numpy(prev))
    want, rtail = RM2._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   None if prev is None else jnp.asarray(prev))
    _close(got, want, 1e-6)
    np.testing.assert_array_equal(tail.numpy(), np.asarray(rtail))


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_mamba_layer_matches_reference(mode):
    cfg, tcfg = _cfg(), _tcfg()
    tree, tparams = _params(cfg)
    w_np = jax.tree.map(lambda a: a[0], tree["layers"][0]["mixer"])
    B, S = 2, (16 if mode == "prefill" else 1)
    x = np.random.default_rng(1).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    rcache = tcache = None
    if mode == "decode":
        h, conv = (a[0] for a in _cache_np(cfg, B, seed=2)[0])
        rcache = RM2.MambaCache(jnp.asarray(h), jnp.asarray(conv))
        tcache = TM2.MambaCache(torch.from_numpy(h), torch.from_numpy(conv))
    want, rnew = RM2.mamba_layer(cfg, jax.tree.map(jnp.asarray, w_np),
                                 jnp.asarray(x), sctx=NULL_CTX, cache=rcache)
    got, tnew = TM2.mamba_layer(tcfg, tparams["layers"][0]["mixer"],
                                torch.from_numpy(x), cache=tcache)
    _close(got, want)
    for g, w in zip(tnew, rnew):
        assert tuple(g.shape) == w.shape
        _close(g, w)


def test_prefill_matches_reference():
    cfg, tcfg = _cfg(), _tcfg()
    tree, tparams = _params(cfg)
    toks = _tokens(cfg, 2, 16)          # two chunks of 8: crosses chunks
    rlogits, rcache = RM.make_prefill_step(cfg, use_pallas=False)(
        jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(toks)})
    tlogits, tcache = TM.make_prefill_step(tcfg)(
        tparams, {"tokens": torch.from_numpy(toks)})
    assert tuple(tlogits.shape) == (2, 1, cfg.vocab_size)
    _close(tlogits, rlogits)
    assert all(isinstance(c, TM2.MambaCache) for c in tcache)
    for (th, tconv), (rh, rconv) in zip(P.cache_to_numpy(tcache, tcfg), rcache):
        _close(th, rh)
        _close(tconv, rconv)


def test_decode_steps_match_reference_on_shared_cache():
    cfg, tcfg = _cfg(), _tcfg()
    tree, tparams = _params(cfg, seed=1)
    B, steps = 2, 5
    cache_np = _cache_np(cfg, B, seed=3)
    rcache = [RM2.MambaCache(*map(jnp.asarray, c)) for c in cache_np]
    tcache = P.cache_from_numpy(cache_np, device="cpu")
    assert all(isinstance(c, TM2.MambaCache) for c in tcache)
    rdecode = jax.jit(RM.make_decode_step(cfg))
    rparams = jax.tree.map(jnp.asarray, tree)
    tdecode = TM.make_decode_step(tcfg)
    toks = _tokens(cfg, B, steps, seed=4)
    for t in range(steps):
        rl, rcache = rdecode(rparams, jnp.asarray(toks[:, t:t + 1]), rcache,
                             jnp.int32(t))
        tl, tcache = tdecode(tparams, torch.from_numpy(toks[:, t:t + 1]),
                             tcache, t)
        _close(tl, rl)
    for (th, tconv), (rh, rconv) in zip(P.cache_to_numpy(tcache, tcfg), rcache):
        _close(th, rh)
        _close(tconv, rconv)


def test_prefill_decode_consistency():
    """The port alone, as tests/test_models_smoke.py checks the reference:
    token-by-token decode reproduces the prefill's last-token logits."""
    tcfg = _tcfg()
    params = TT.init_params(tcfg, 1, device="cpu")
    B, S = 2, 16
    toks = torch.from_numpy(_tokens(tcfg, B, S, seed=5))
    logits_p, _ = TM.make_prefill_step(tcfg)(params, {"tokens": toks})
    decode = TM.make_decode_step(tcfg)
    cache = TT.init_cache(tcfg, B, 32, tcfg.dtype, device="cpu")
    for t in range(S):
        lg, cache = decode(params, toks[:, t:t + 1], cache, t)
    assert not torch.isnan(lg).any()
    np.testing.assert_allclose(lg.numpy(), logits_p.numpy(), atol=0.1, rtol=0.1)
    assert (lg.argmax(-1) == logits_p.argmax(-1)).all()


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_init_params_count_and_dtypes():
    cfg = TC.reduce_config(TC.get_config(ARCH))
    params = TT.init_params(cfg, 0, device="cpu")
    assert sum(t.numel() for t in _leaves(params)) == cfg.param_count()
    mixer = params["layers"][0]["mixer"]
    for name in ("A_log", "D", "dt_bias"):         # the reference's rule
        t = mixer[name]
        assert t.dtype == torch.float32
        assert float(t.min()) >= 0.5 and float(t.max()) < 1.5
    assert mixer["in_proj"].dtype == torch.bfloat16
    # full width: count the spec's shapes rather than fill 1.34B weights
    full = TC.get_config(ARCH)
    assert sum(int(np.prod(shape)) for shape, _ in _leaves(
        TT.param_specs(full))) == full.param_count() == 1343335424


def test_cache_specs_match_reference():
    cfg, tcfg = _cfg("bfloat16"), _tcfg("bfloat16")
    ref = RT.cache_specs(cfg, 3, 20, cfg.dtype)
    port = TT.cache_specs(tcfg, 3, 20, tcfg.dtype)
    assert len(port) == sum(spec.h.shape[0] for spec in ref)
    for i, spec in enumerate(port):
        want = ref[i % len(ref)]
        assert isinstance(spec, TM2.MambaCache)
        for t, w in zip(spec, want):
            assert tuple(t.shape) == tuple(w.shape[1:])
            assert str(t.dtype).split(".")[1] == str(w.dtype)
            assert t.device.type == "meta"


def test_params_round_trip_of_a_bf16_tree():
    """A bf16 model keeps A_log, D and dt_bias in float32 on the way in, and
    every value survives the way back."""
    cfg, tcfg = _cfg("bfloat16"), _tcfg("bfloat16")
    tree, tparams = _params(cfg, seed=2)
    for layer in tparams["layers"]:
        mixer = layer["mixer"]
        assert {k: mixer[k].dtype for k in ("A_log", "D", "dt_bias")} == \
            dict.fromkeys(("A_log", "D", "dt_bias"), torch.float32)
        assert {k: mixer[k].dtype for k in ("in_proj", "conv_w", "out_proj")} == \
            dict.fromkeys(("in_proj", "conv_w", "out_proj"), torch.bfloat16)
    back = P.to_numpy_tree(tparams, tcfg)
    flat_a, def_a = jax.tree.flatten(tree)
    flat_b, def_b = jax.tree.flatten(back)
    assert def_a == def_b
    assert {a.dtype.name for a in flat_a} == {"bfloat16", "float32"}
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a.astype(np.float32), b)
