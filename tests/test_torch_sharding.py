"""Port parity for sharding: ``repro_torch.sharding``, ``launch.mesh``, the
sharded wrappers and the model on a ``DeviceMesh`` through DTensor.

Partitioning is pure logic on ``{axis: size}`` meshes and is held entry for
entry against the reference's ``spec_for``, ``param_pspecs`` and
``cache_axes``.  ``q_offset`` (the sequence-parallel chunk's start) runs in
one process against the reference's ``blockwise_attention``.  Everything
with collectives runs in gloo worlds of CPU processes
(``tests/_torch_dist.py``: a ``FileStore`` under ``tmp_path``, a join
timeout per world); one world of 8 ranks runs every sharded case of this
file, and the workers import neither ``jax`` nor ``repro``: the reference's
values are computed here and compared with what the ranks return.
Tolerances: attention o within 3e-5 (f32, tests/test_kernels.py), each
gradient within 1e-4 of its largest magnitude (tests/test_torch_train.py);
the model's loss within 1e-5 and each grad leaf within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as D
import test_torch_train as TT
from repro import configs as RC
from repro.kernels.ref import ssd_reference
from repro.models import attention as RA
from repro.models import model as RM
from repro.models import transformer as RT
from repro.sharding.partition import PartitionRules as RRules
from repro_torch import configs as TC
from repro_torch import params as P
from repro_torch.kernels import ops
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT_
from repro_torch.sharding import PartitionRules, ShardCtx

ARCHS = ["smollm-360m", "mamba2-1.3b", "qwen3-moe-235b-a22b", "dbrx-132b",
         "jamba-1.5-large-398b", "gemma2-9b", "internvl2-76b",
         "musicgen-large", "granite-3-2b", "internlm2-1.8b"]
FAKE_MESHES = [{"data": 16, "model": 16}, {"data": 2, "model": 4},
               {"pod": 2, "data": 16, "model": 16}]


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


# ------------------------------ partitioning ----------------------------- #

def test_partition_fallbacks():
    """The degenerate mesh: everything falls back to replicated."""
    r = PartitionRules()
    assert r.spec_for(("vocab", "embed_w"), (1000, 64),
                      {"data": 1, "model": 1}) == ()
    assert ShardCtx(None).act("x", ("batch",)) == "x"
    assert ShardCtx(None).spec(("batch",), (4,)) == ()


def test_partition_divisibility_logic():
    r, m = PartitionRules(), {"data": 16, "model": 16}
    # smollm: 15 heads cannot shard on model=16 -> falls to head_dim
    assert r.spec_for(("embed_w", "heads", "head_dim"), (960, 15, 64),
                      m) == ("data", None, "model")
    # granite vocab 49155 not divisible by 16 -> replicated vocab dim
    assert r.spec_for(("vocab", "embed_w"), (49155, 2048), m) == (None, "data")
    # qwen kv heads 4 not divisible -> None
    assert r.spec_for(("embed_w", "kv_heads", "head_dim"), (4096, 4, 64),
                      m) == ("data", None, "model")
    # a pod axis composes with data on the batch; the model axis is used once
    assert r.spec_for(("batch", "seq", None), (64, 8, 8),
                      {"pod": 2, "data": 16, "model": 16}) == (("pod", "data"),)
    assert r.spec_for(("heads", "head_dim"), (16, 64), m) == ("model",)


def _ref_layer_specs(tree, cfg):
    """The reference's stacked specs, one entry per layer of the port."""
    period = len(tree["layers"])
    out = {k: v for k, v in tree.items() if k != "layers"}
    out["layers"] = [tree["layers"][i % period]
                     for i in range(cfg.num_layers)]
    return out


def _spec_leaves(tree, drop_layer_axis):
    out = []

    def walk(t, in_layers):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], in_layers or k == "layers")
        elif isinstance(t, list):
            for c in t:
                walk(c, in_layers)
        else:
            spec = tuple(t)
            out.append(spec[1:] if in_layers and drop_layer_axis else spec)
    walk(tree, False)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_reference(arch):
    """The port's per-layer specs are the reference's stacked ones without
    their leading "layers" entry, for every leaf of every arch at full
    width, on three fake meshes; and the logical axes agree likewise."""
    rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    for shape in FAKE_MESHES:
        want = _ref_layer_specs(RT.param_pspecs(rcfg, _FakeMesh(shape),
                                                RRules()), rcfg)
        got = TT_.param_pspecs(tcfg, shape)
        assert _spec_leaves(got, False) == _spec_leaves(want, True), shape
    axes_ref = _ref_layer_specs(RT.param_axes(rcfg), rcfg)
    assert (_spec_leaves(TT_.param_axes(tcfg), False)
            == _spec_leaves(axes_ref, True))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_match_reference(arch):
    """Each layer's cache axes are the reference's without "layers", and
    resolve to the same specs on the fake meshes at a decode batch of 8
    and 32k positions."""
    rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    ref, got = RT.cache_axes(rcfg), TT_.cache_axes(tcfg)
    period = len(ref)
    assert len(got) == tcfg.num_layers
    shapes = TT_.cache_specs(tcfg, 8, 32768)
    for i, (entry, shp) in enumerate(zip(got, shapes)):
        want = ref[i % period]
        assert type(entry).__name__ == type(want).__name__
        for ax, wax, t in zip(entry, want, shp):
            assert ax == tuple(wax[1:])
            for mesh in FAKE_MESHES:
                assert (PartitionRules().spec_for(ax, t.shape, mesh)
                        == tuple(RRules().spec_for(wax, (1,) + t.shape,
                                                   _FakeMesh(mesh)))[1:])


def test_tree_specs_resolve_each_leaf():
    """``tree_specs`` maps a tree of logical axes beside a tree of shaped
    leaves (NamedTuples and lists too) to each leaf's ``spec_for``."""
    cfg = TC.get_config("jamba-1.5-large-398b")
    axes, shapes = TT_.cache_axes(cfg), TT_.cache_specs(cfg, 16, 4096)
    mesh = {"data": 16, "model": 16}
    got = PartitionRules().tree_specs(axes, shapes, mesh)
    assert [type(e) for e in got] == [type(e) for e in axes]
    for e, a, t in zip(got, axes, shapes):
        assert tuple(e) == tuple(PartitionRules().spec_for(x, y.shape, mesh)
                                 for x, y in zip(a, t))


# -------------------------------- q_offset ------------------------------- #

# (B, Sq, Skv, Hq, Hkv, D), q_offset, window, cap: D = 16 and 256, a window
# and a cap, offsets that are and are not multiples of 64 and 128, Sq that
# does not divide Skv, and a chunk that starts past some of its keys' window
Q_OFFSET_CASES = [
    ((2, 40, 160, 4, 2, 16), 64, 0, 0.0),
    ((1, 48, 200, 4, 2, 16), 129, 13, 30.0),
    ((2, 30, 140, 2, 1, 16), 110, 0, 30.0),
    ((1, 36, 300, 2, 1, 256), 128, 0, 50.0),
    ((1, 50, 260, 2, 2, 256), 77, 40, 50.0),
    ((1, 64, 256, 4, 2, 256), 192, 9, 0.0),
]


@pytest.mark.parametrize("shape,q_offset,window,cap", Q_OFFSET_CASES)
def test_blockwise_attention_q_offset_matches_reference(shape, q_offset,
                                                        window, cap):
    """The port's ``ops.blockwise_attention`` (plain path) on a chunk of q
    at ``q_offset`` against the reference's ``blockwise_attention`` at the
    same offset: o and the gradients of jax.vjp, f32 within 3e-5."""
    B, Sq, Skv, Hq, Hkv, Dh = shape
    rng = np.random.default_rng(3)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, Sq, Hq, Dh), (B, Skv, Hkv, Dh),
                             (B, Skv, Hkv, Dh), (B, Sq, Hq, Dh)))
    out, vjp = jax.vjp(lambda q_, k_, v_: RA.blockwise_attention(
        q_, k_, v_, jnp.int32(q_offset), True, window, cap, 32, 32),
        *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = ops.blockwise_attention(*ts, q_offset, True, window, cap)
    got = [o] + list(torch.autograd.grad(o, ts, torch.from_numpy(do)))
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=3e-5,
                                   rtol=3e-5, err_msg=name)


# ------------------------------ one world -------------------------------- #

# attention: (mesh dims, B, S, Hq, Hkv, D) with reduced gemma2's window
# and cap, and the strategy the reference picks for it
ATTN_CASES = [
    ({"data": 4, "model": 2}, (4, 16, 4, 2, 16), "kv_heads"),
    ({"data": 2, "model": 4}, (2, 16, 4, 1, 16), "q_heads"),
    ({"data": 1, "model": 8}, (2, 16, 4, 2, 16), "seq"),
    ({"data": 4, "model": 2}, (4, 16, 15, 5, 16), "seq"),    # smollm's heads
    ({"data": 2, "model": 4}, (2, 16, 15, 5, 16), "seq"),
]
GEMMA = RC.reduce_config(RC.get_config("gemma2-9b"))
WINDOW, CAP = 5, GEMMA.attn_softcap
# decode: the cache's seq dim on data (a batch of 1 leaves data to it) with
# head_dim on model, and the batch on data with head_dim on model
DECODE_CASES = [({"data": 2, "model": 4}, 1), ({"data": 2, "model": 4}, 2)]
MODEL_ARCHS = ["qwen3-moe-235b-a22b", "gemma2-9b"]
STEP_CASES = [("qwen3-moe-235b-a22b", 2), ("gemma2-9b", 1)]   # microbatches
MESH = {"data": 2, "model": 4}


def _attn_inputs(shape, seed):
    B, S, Hq, Hkv, Dh = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, Hq, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh),
                      (B, S, Hq, Dh))]


def _decode_inputs(B, seed, S=32, Hq=4, Hkv=2, Dh=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(B, 1, Hq, Dh), f(B, S, Hkv, Dh), f(B, S, Hkv, Dh),
            f(B, 1, Hkv, Dh), f(B, 1, Hkv, Dh))


def _ssd_inputs(seed, B=2, S=32, H=8, Ph=4, N=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, Ph)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (B, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    dy = rng.standard_normal((B, S, H, Ph)).astype(np.float32)
    return x, dt, A, Bm, Cm, dy


def _model_case(arch):
    rcfg, _ = TT._cfgs(arch)
    rcfg = dataclasses.replace(rcfg, num_layers=2)
    over = dict(dtype="float32", num_layers=2)
    if rcfg.num_experts:
        over["capacity_factor"] = rcfg.capacity_factor
    tree, _ = TT._params(rcfg, 0)
    return rcfg, over, tree, TT._batch(rcfg, B=4, S=16)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every sharded case of this file in one gloo world of 8 ranks."""
    jobs = {
        "attn": (D.attention_cases, ([
            (dims, *_attn_inputs(shape, i), WINDOW, CAP)
            for i, (dims, shape, _) in enumerate(ATTN_CASES)],)),
        "decode": (D.decode_cases, ([
            (dims, *_decode_inputs(B, 10 + B), 20, WINDOW, CAP)
            for dims, B in DECODE_CASES],)),
        "ssd": (D.ssd_case, (MESH, *_ssd_inputs(5), 8)),
    }
    for arch in MODEL_ARCHS:
        _, over, tree, batch = _model_case(arch)
        jobs[arch] = (D.model_loss_and_grads,
                      (arch, over, MESH, tree, batch))
    for arch, mb in STEP_CASES:
        _, over, tree, batch = _model_case(arch)
        jobs[f"{arch}/step{mb}"] = (D.model_loss_and_grads,
                                    (arch, over, MESH, tree, batch, mb))
    return D.run_world(D.run_jobs, 8, tmp_path_factory.mktemp("world"), jobs,
                       timeout=240)[0]


def _leaf_close(got, want, rel, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


@pytest.mark.parametrize("case", range(len(ATTN_CASES)))
def test_sharded_flash_attention_strategies_match_reference(world, case):
    """Each strategy of ``sharded_flash_attention`` against the reference's
    unsharded ``blockwise_attention``, o and the gradients of jax.vjp."""
    dims, shape, strategy = ATTN_CASES[case]
    q, k, v, do = _attn_inputs(shape, case)
    out, vjp = jax.vjp(lambda q_, k_, v_: RA.blockwise_attention(
        q_, k_, v_, jnp.int32(0), True, WINDOW, CAP, 8, 8),
        *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    got = world["attn"][case]
    assert got[0] == strategy
    np.testing.assert_allclose(got[1], np.asarray(out), atol=3e-5, rtol=3e-5)
    for name, g, w in zip(("dq", "dk", "dv"), got[2:], want):
        _leaf_close(g, w, 1e-4, f"{strategy} {name}")


@pytest.mark.parametrize("case", range(len(DECODE_CASES)))
def test_sharded_decode_attention_matches_reference(world, case):
    """The cache's seq dim or batch on data, head_dim on model: out and
    the written caches against the reference's unsharded decode."""
    dims, B = DECODE_CASES[case]
    q, kc, vc, kx, vx = _decode_inputs(B, 10 + B)
    kw = jax.lax.dynamic_update_slice_in_dim(jnp.asarray(kc), kx, 20, 1)
    vw = jax.lax.dynamic_update_slice_in_dim(jnp.asarray(vc), vx, 20, 1)
    want = RA.decode_attention(jnp.asarray(q), kw, vw, 20, window=WINDOW,
                               attn_softcap=CAP)
    spec, o, k2, v2 = world["decode"][case]
    assert spec == ((None, "data", None, "model") if B == 1
                    else ("data", None, None, "model"))
    np.testing.assert_allclose(o, np.asarray(want), atol=3e-5, rtol=3e-5)
    np.testing.assert_array_equal(k2, np.asarray(kw))
    np.testing.assert_array_equal(v2, np.asarray(vw))


def test_sharded_ssd_matches_reference(world):
    """Heads on model, batch on data: y, the final state and the gradients
    against the reference's ``ssd_reference`` and its jax.vjp."""
    x, dt, A, Bm, Cm, dy = _ssd_inputs(5)
    (y, h), vjp = jax.vjp(lambda *a: ssd_reference(*a, chunk=8),
                          *map(jnp.asarray, (x, dt, A, Bm, Cm)))
    grads = vjp((jnp.asarray(dy), jnp.zeros_like(h)))
    placements, gy, gh, ggrads = world["ssd"]
    assert "Shard(dim=0)" in placements and "Shard(dim=2)" in placements
    _leaf_close(gy, y, 1e-5, "y")
    _leaf_close(gh, h, 1e-5, "h")
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), ggrads, grads):
        _leaf_close(g, w, 1e-4, name)


def _unsharded(arch):
    rcfg, over, tree, batch = _model_case(arch)
    tcfg = D._port_cfg(arch, over)
    (rloss, rm), rgrads = jax.value_and_grad(
        lambda p: RM.loss_fn(rcfg, p, TT._jax_batch(batch)), has_aux=True)(
            jax.tree.map(jnp.asarray, tree))
    return rcfg, tcfg, tree, batch, float(rloss), rgrads


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_sharded_model_matches_unsharded(world, arch):
    """Reduced qwen3-moe (drop-free) and gemma2 at 2 layers on a (2, 4)
    mesh, B=4 S=16, f32: the sharded port's loss against the reference's
    unsharded ``loss_fn`` within 1e-5 (the reference's own sharded check
    allows 5e-2; measured 4.8e-7 for qwen3-moe, 0 for gemma2), and every
    grad leaf, gathered, within 1e-4 of its largest magnitude of the
    reference's and of the port's unsharded grads (measured 1.6e-6 and
    1.1e-6)."""
    rcfg, tcfg, tree, batch, rloss, rgrads = _unsharded(arch)
    got = world[arch]
    assert got["dtensor"]
    assert abs(got["loss"] - rloss) <= 1e-5
    grads, metrics = TM.make_loss_and_grad(tcfg)(
        P.from_numpy_tree(tree, device="cpu"), TT._torch_batch(batch))
    assert abs(got["loss"] - float(metrics["loss"])) <= 1e-5
    assert abs(got["aux"] - float(metrics["aux"])) <= 1e-5
    mine = P.to_numpy_tree(grads, tcfg)
    for g, w, m in zip(jax.tree.leaves(got["grads"]),
                       jax.tree.leaves(jax.tree.map(np.asarray, rgrads)),
                       jax.tree.leaves(mine)):
        _leaf_close(g, w, 1e-4, arch)
        _leaf_close(g, m, 1e-4, arch)


@pytest.mark.parametrize("arch,microbatches", STEP_CASES)
def test_sharded_train_step_matches_unsharded(world, arch, microbatches):
    """One AdamW step under the mesh (``microbatches`` 1 and 2, the
    accumulators pinned to the params' placements): grad_norm and loss
    equal the unsharded step's, and the updated params too (each leaf
    within 1e-4 of its largest magnitude); params and moments stay
    DTensors."""
    from repro_torch.optim import AdamW
    _, over, tree, batch = _model_case(arch)
    tcfg = D._port_cfg(arch, over)
    opt = AdamW()
    params = P.from_numpy_tree(tree, device="cpu")
    step = TM.make_train_step(tcfg, opt, microbatches=microbatches)
    params, _, metrics = step(params, opt.init(params),
                              TT._torch_batch(batch))
    got = world[f"{arch}/step{microbatches}"]
    assert got["dtensor"]
    assert got["metrics"]["grad_norm"] == pytest.approx(
        float(metrics["grad_norm"]), rel=1e-5)
    assert abs(got["metrics"]["loss"] - float(metrics["loss"])) <= 1e-5
    for g, w in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(P.to_numpy_tree(params, tcfg))):
        _leaf_close(g, w, 1e-4, arch)
