"""Port parity for the model: reduced smollm-360m in f32 on the CPU.

The reference's ``T.init_params`` is converted through numpy into the
port's layout (``repro_torch.params``), and the same tokens go through both
packages.  Tolerance 1e-4 on logits and caches: the same f32 arithmetic in
another summation order, through two layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import attention as RA
from repro.models import model as RM
from repro.models import transformer as RT
from repro_torch import configs as TC
from repro_torch import params as P
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT

TOL = 1e-4


def _cfg():
    cfg = RC.reduce_config(RC.get_config("smollm-360m"))
    return dataclasses.replace(cfg, dtype="float32")


def _tcfg():
    cfg = TC.reduce_config(TC.get_config("smollm-360m"))
    return dataclasses.replace(cfg, dtype="float32")


def _params(cfg, seed=0):
    tree = jax.tree.map(np.asarray, RT.init_params(cfg, jax.random.PRNGKey(seed)))
    return tree, P.from_numpy_tree(tree, device="cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_matches_reference(use_pallas):
    cfg, tcfg = _cfg(), _tcfg()
    tree, tparams = _params(cfg)
    toks = _tokens(cfg, 2, 12)
    rlogits, rcache = RM.make_prefill_step(cfg, use_pallas=use_pallas)(
        jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(toks)})
    tlogits, tcache = TM.make_prefill_step(tcfg)(
        tparams, {"tokens": torch.from_numpy(toks)})
    assert tuple(tlogits.shape) == (2, 1, cfg.vocab_size)
    _close(tlogits, rlogits)
    for (tk, tv), (rk, rv) in zip(P.cache_to_numpy(tcache, tcfg), rcache):
        _close(tk, rk)
        _close(tv, rv)


def test_decode_steps_match_reference_on_shared_cache():
    cfg, tcfg = _cfg(), _tcfg()
    tree, tparams = _params(cfg, seed=1)
    B, S, steps = 2, 16, 5
    rng = np.random.default_rng(3)
    period = RT.program_period(cfg)
    shape = (cfg.num_layers // period, B, S, cfg.num_kv_heads, cfg.head_dim)
    cache_np = [tuple(rng.standard_normal(shape).astype(np.float32)
                      for _ in range(2)) for _ in range(period)]
    rcache = [RA.AttnCache(jnp.asarray(k), jnp.asarray(v)) for k, v in cache_np]
    tcache = P.cache_from_numpy(cache_np, device="cpu")
    rdecode = jax.jit(RM.make_decode_step(cfg))
    rparams = jax.tree.map(jnp.asarray, tree)
    tdecode = TM.make_decode_step(tcfg)
    toks = _tokens(cfg, B, steps, seed=4)
    for t in range(steps):
        pos = 3 + 2 * t
        rl, rcache = rdecode(rparams, jnp.asarray(toks[:, t:t + 1]), rcache,
                             jnp.int32(pos))
        tl, tcache = tdecode(tparams, torch.from_numpy(toks[:, t:t + 1]),
                             tcache, pos)
        _close(tl, rl)
    for (tk, tv), (rk, rv) in zip(P.cache_to_numpy(tcache, tcfg), rcache):
        _close(tk, rk)
        _close(tv, rv)


def test_prefill_decode_consistency():
    """The port alone, as tests/test_models_smoke.py checks the reference:
    token-by-token decode reproduces the prefill's last-token logits."""
    tcfg = _tcfg()
    params = TT.init_params(tcfg, 1, device="cpu")
    B, S = 2, 8
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


def test_init_params_count_matches_config():
    cfg = TC.reduce_config(TC.get_config("smollm-360m"))
    params = TT.init_params(cfg, 0, device="cpu")
    assert sum(t.numel() for t in _leaves(params)) == cfg.param_count()
    # full width: count the spec's shapes rather than fill 362M weights
    full = TC.get_config("smollm-360m")
    assert sum(int(np.prod(shape)) for shape, _ in _leaves(
        TT.param_specs(full))) == full.param_count()


def test_cache_specs_match_reference():
    cfg, tcfg = _cfg(), _tcfg()
    ref = RT.cache_specs(cfg, 3, 20, "float32")
    port = TT.cache_specs(tcfg, 3, 20, "float32")
    assert len(port) == sum(spec.k.shape[0] for spec in ref)
    for i, spec in enumerate(port):
        want = ref[i % len(ref)]
        for t, w in zip(spec, want):
            assert tuple(t.shape) == tuple(w.shape[1:])
            assert t.dtype == torch.float32 and t.device.type == "meta"


def test_params_round_trip():
    cfg, tcfg = _cfg(), _tcfg()
    tree, tparams = _params(cfg, seed=2)
    back = P.to_numpy_tree(tparams, tcfg)
    flat_a, def_a = jax.tree.flatten(tree)
    flat_b, def_b = jax.tree.flatten(back)
    assert def_a == def_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_configs_equal_reference(arch):
    ref, port = RC.get_config(arch), TC.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (dataclasses.asdict(TC.reduce_config(port))
            == dataclasses.asdict(RC.reduce_config(ref)))
    assert port.param_count() == ref.param_count()
    assert {k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in RC.SHAPES.items()}
