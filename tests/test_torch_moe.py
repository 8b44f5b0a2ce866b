"""Port parity for the Mixture-of-Experts FFN (``models/moe.py``) on the CPU.

The same inputs, drawn with numpy from a seed, go through the reference's
``repro.models.moe`` and the port's ``repro_torch.models.moe``.
Tolerances are those of tests/test_kernels.py: f32 3e-5, bf16 3e-2.  In
bf16 the two packages' router logits round differently, so a near-tie can
send a token to another expert: there the test replays the reference's
expert choices in the port (its gates recomputed from the port's own
probabilities) and reports how many choices differed unpinned.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:                      # fall back to the vendored shim
    from _propshim import given, settings, st

from repro import configs as RC
from repro.models import moe as RMOE
from repro.sharding.partition import NULL_CTX
from repro_torch import configs as TC
from repro_torch.models import moe as TMOE

MOE_ARCHS = ["qwen3-moe-235b-a22b", "dbrx-132b", "jamba-1.5-large-398b"]
TOL = {"float32": 3e-5, "bfloat16": 3e-2}   # tests/test_kernels.py
_NP = {"float32": np.float32, "bfloat16": jnp.bfloat16}


def _cfgs(arch="qwen3-moe-235b-a22b", **over):
    return (dataclasses.replace(RC.reduce_config(RC.get_config(arch)), **over),
            dataclasses.replace(TC.reduce_config(TC.get_config(arch)), **over))


def _weights(cfg, seed=0):
    """Expert weights at the reference init's scale (normal x fan_in^-1/2)."""
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.num_experts, cfg.d_ff
    draw = lambda shape, fan_in: (rng.standard_normal(shape)
                                  / np.sqrt(fan_in)).astype(np.float32)
    w = {"router": draw((d, e), d), "wi": draw((e, d, f), d),
         "wo": draw((e, f, d), f)}
    if cfg.gated_mlp:
        w["wg"] = draw((e, d, f), d)
    return w


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _ref(a, dtype="float32"):
    return jnp.asarray(a).astype(_NP[dtype])


def _port(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a)).to(getattr(torch, dtype))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not \
        isinstance(a, torch.Tensor) else a.float().numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _both(cfg, tcfg, w, x, dtype="float32", **kw):
    """(reference out, aux), (port out, aux) of moe_ffn on the same inputs."""
    rw = {k: _ref(v, dtype) for k, v in w.items()}
    tw = {k: _port(v, dtype) for k, v in w.items()}
    return (RMOE.moe_ffn(_ref(x, dtype), rw, cfg, NULL_CTX, **kw),
            TMOE.moe_ffn(_port(x, dtype), tw, tcfg, **kw))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_spec_matches_reference(arch):
    cfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    assert TMOE.moe_params_spec(tcfg) == RMOE.moe_params_spec(cfg)


@pytest.mark.parametrize("E,K", [(4, 2), (16, 4), (128, 8)])
def test_route_matches_reference(E, K):
    """f32: the same experts in the same order, gates and aux within 3e-5."""
    cfg, tcfg = _cfgs(num_experts=E, num_experts_per_tok=K)
    x = _x((2, 24, cfg.d_model))
    w = _weights(cfg)["router"]
    rg, ri, raux = RMOE._route(jnp.asarray(x), jnp.asarray(w), cfg)
    tg, ti, taux = TMOE._route(torch.from_numpy(x), torch.from_numpy(w), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    _close(tg, rg, TOL["float32"])
    assert abs(float(taux) - float(raux)) <= TOL["float32"]


def test_route_ties_put_the_lower_expert_first():
    """Experts with equal probability are taken lowest index first, as
    ``jax.lax.top_k`` takes them.  The tied logits are exactly 0 (zero
    router columns); the others are negative."""
    cfg, tcfg = _cfgs(num_experts=8, num_experts_per_tok=3)
    x = np.abs(_x((1, 5, cfg.d_model))) + 0.1
    w = np.full((cfg.d_model, 8), -0.05, np.float32)
    w[:, [1, 4, 6, 7]] = 0.0
    for router in (w, np.zeros_like(w)):
        _, ri, _ = RMOE._route(jnp.asarray(x), jnp.asarray(router), cfg)
        _, ti, _ = TMOE._route(torch.from_numpy(x), torch.from_numpy(router),
                               tcfg)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(ti.numpy(), np.broadcast_to([0, 1, 2],
                                                              ti.shape))
    _, ti, _ = TMOE._route(torch.from_numpy(x), torch.from_numpy(w), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.broadcast_to([1, 4, 6],
                                                              ti.shape))


def test_positions_match_reference():
    rng = np.random.default_rng(0)
    for G, T, K, E in ((1, 7, 1, 4), (2, 16, 2, 4), (3, 40, 8, 16)):
        idx = rng.integers(0, E, size=(G, T, K))
        want = np.asarray(RMOE._positions(jnp.asarray(idx), E, T * K))
        got = TMOE._positions(torch.from_numpy(idx), E, T * K)
        np.testing.assert_array_equal(got.numpy(), want)


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 500))
def test_positions_property(seed):
    """Slot positions are unique per expert and dense from 0 (the property
    of tests/test_substrate.py::test_moe_positions_property)."""
    rng = np.random.default_rng(seed)
    G, T, K, E = 2, 16, 2, 4
    idx = rng.integers(0, E, size=(G, T, K))
    pos = TMOE._positions(torch.from_numpy(idx), E, C=T * K).numpy()
    for g in range(G):
        for e in range(E):
            got = sorted(pos[g][idx[g] == e].tolist())
            assert got == list(range(len(got)))


class _Stop(Exception):
    pass


def _capacity_of(module, call):
    """(group shape, C) that ``moe_ffn`` hands ``module._positions``."""
    seen = []
    real = module._positions

    def spy(idx, E, C):
        seen.append((tuple(idx.shape), C))
        raise _Stop
    module._positions = spy
    try:
        with pytest.raises(_Stop):
            call()
    finally:
        module._positions = real
    return seen[0]


def test_capacity_matches_reference():
    """Both packages hand ``_positions`` the same groups and the same C over
    a grid of token counts, experts, top-k, capacity factors and group
    sizes (caught at the call; nothing after it runs)."""
    n = 0
    for T in (1, 3, 20, 96):
        for E, K in ((4, 1), (4, 2), (16, 4), (128, 8)):
            for cf in (0.5, 1.25, 16.0):
                for gs in (4096, 16):
                    cfg, tcfg = _cfgs(num_experts=E, num_experts_per_tok=K,
                                      capacity_factor=cf, d_model=8)
                    w = _weights(cfg)
                    x = _x((1, T, 8))
                    want = _capacity_of(RMOE, lambda: RMOE.moe_ffn(
                        jnp.asarray(x), w, cfg, NULL_CTX, group_size=gs))
                    got = _capacity_of(TMOE, lambda: TMOE.moe_ffn(
                        torch.from_numpy(x),
                        {k: torch.from_numpy(v) for k, v in w.items()}, tcfg,
                        group_size=gs))
                    assert got == want, (T, E, K, cf, gs)
                    Tg = want[0][1]
                    assert got[1] == TMOE._capacity(Tg, K, E, cf)
                    n += 1
    assert n == 4 * 4 * 3 * 2


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("group_size", [4096, 8])
def test_moe_ffn_matches_reference_f32(dispatch, group_size):
    """Each dispatch against the reference's same dispatch where no
    assignment drops (capacity_factor E/K: C = Tg), and against the
    reference's einsum, the function, at the config's 1.25; 3e-5."""
    for cf, ref_dispatch in ((2.0, dispatch), (1.25, "einsum")):
        cfg, tcfg = _cfgs(capacity_factor=cf)
        cfg = dataclasses.replace(cfg, moe_dispatch=ref_dispatch)
        tcfg = dataclasses.replace(tcfg, moe_dispatch=dispatch)
        x = _x((2, 16, cfg.d_model))
        (rout, raux), (tout, taux) = _both(cfg, tcfg, _weights(cfg), x,
                                           group_size=group_size)
        assert tuple(tout.shape) == x.shape and tout.dtype == torch.float32
        _close(tout, rout, TOL["float32"])
        assert abs(float(taux) - float(raux)) <= TOL["float32"]


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_moe_ffn_matches_reference_bf16(dispatch):
    """bf16 at 3e-2, with the reference's expert choices replayed in the
    port; the share of choices that differ unpinned is reported."""
    cfg, tcfg = _cfgs(moe_dispatch=dispatch)
    cfg = dataclasses.replace(cfg, moe_dispatch="einsum")
    w = _weights(cfg)
    x = _x((2, 32, cfg.d_model))
    rec = []
    real_ref, real_port = RMOE._route, TMOE._route

    def recording(x, router_w, cfg):
        out = real_ref(x, router_w, cfg)
        rec.append(np.array(out[1]))
        return out

    def replaying(x, router_w, cfg):
        idx = torch.from_numpy(rec[0]).long()
        return TMOE._gates_at(TMOE._router_probs(x, router_w), idx,
                              cfg.num_experts)
    RMOE._route = recording
    try:
        (rout, raux), (tout, taux) = _both(cfg, tcfg, w, x, "bfloat16")
    finally:
        RMOE._route = real_ref
    unpinned = real_port(_port(x, "bfloat16").reshape(1, 64, -1),
                         _port(w["router"], "bfloat16"), tcfg)[1].numpy()
    flipped = float((unpinned != rec[0]).mean())
    print(f"bf16 {dispatch}: {flipped:.4f} of the (token, k) choices differ "
          "between the packages unpinned")
    TMOE._route = replaying
    try:
        tout, taux = TMOE.moe_ffn(_port(x, "bfloat16"),
                                  {k: _port(v, "bfloat16") for k, v in w.items()},
                                  tcfg)
    finally:
        TMOE._route = real_port
    assert tout.dtype == torch.bfloat16
    _close(tout, rout, TOL["bfloat16"])
    assert abs(float(taux) - float(raux)) <= TOL["bfloat16"]


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_gather_equals_einsum_when_an_expert_overflows(dispatch):
    """Every token's first choice is expert E-1, which overflows: C = 20
    slots for 32 first choices.  A kept token then holds slot (E-1, C-1),
    where the reference's gather also scatters its dropped assignments
    (ROADMAP queue 3).  The port's gather and einsum both equal the
    reference's einsum within 3e-5."""
    cfg, tcfg = _cfgs()
    tcfg = dataclasses.replace(tcfg, moe_dispatch=dispatch)
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    w = _weights(cfg)
    x = np.abs(_x((2, 16, cfg.d_model))) + 0.1
    w["router"][:, E - 1] = 1.0                     # a dominant column
    tx = torch.from_numpy(x).reshape(1, 32, -1)
    _, idx, _ = TMOE._route(tx, torch.from_numpy(w["router"]), tcfg)
    C = TMOE._capacity(32, K, E, cfg.capacity_factor)
    pos = TMOE._positions(idx, E, C)
    keep = pos < C
    assert C == 20 and bool((idx[..., 0] == E - 1).all())
    assert int((~keep).sum()) >= 12
    assert bool((keep & (idx == E - 1) & (pos == C - 1)).any())
    (rout, raux), (tout, taux) = _both(cfg, tcfg, w, x)
    _close(tout, rout, TOL["float32"])
    assert abs(float(taux) - float(raux)) <= TOL["float32"]
    rgather, _ = RMOE.moe_ffn(jnp.asarray(x), w, dataclasses.replace(
        cfg, moe_dispatch="gather"), NULL_CTX)
    diff = np.abs(np.asarray(rgather) - np.asarray(rout)).max(axis=-1)
    print(f"the reference's gather against its einsum: tokens "
          f"{np.argwhere(diff > TOL['float32']).tolist()} differ, by up to "
          f"{diff.max():.4g}; {int((~keep).sum())} assignments dropped")


def test_moe_ffn_raises_when_tokens_do_not_split_into_groups():
    """9 tokens in groups of 4: the reference fails in its reshape; the
    port raises ValueError and does not pad."""
    cfg, tcfg = _cfgs()
    w = _weights(cfg)
    x = _x((1, 9, cfg.d_model))
    with pytest.raises(TypeError):
        RMOE.moe_ffn(jnp.asarray(x), w, cfg, NULL_CTX, group_size=4)
    with pytest.raises(ValueError, match="do not split"):
        TMOE.moe_ffn(torch.from_numpy(x),
                     {k: torch.from_numpy(v) for k, v in w.items()}, tcfg,
                     group_size=4)
