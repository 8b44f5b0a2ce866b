"""Port parity for the train step: reduced smollm-360m in f32 on the CPU,
and the other layer kinds: reduced mamba2-1.3b, jamba-1.5-large-398b,
qwen3-moe-235b-a22b and dbrx-132b.

The reference's ``init_params`` tree is converted through numpy into the
port's layout (``repro_torch.params``), the same batch goes through both
packages, and the port's loss and every gradient leaf are held against
``jax.value_and_grad(loss_fn)``: loss within 1e-5, each gradient leaf
within 1e-4 of that leaf's largest magnitude (the same f32 arithmetic in
another summation order, through two layers and the flash backward).

The params are the reference's init with wq, wk and wv rescaled to
fan_in = d_model, as ``chip_smoke.smoke_params`` does at full width.  The
reference's init takes the head count as their fan_in
(src/repro/models/transformer.py:153), which makes the scores so sharp
that one f32 ulp of change in the params moves the gradients by 3e-5 to
6e-5 of their size, against under 2e-6 with the rescale
(tools/train_sensitivity.py): the tolerance could then hardly tell a
fault from rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import model as RM
from repro.models import transformer as RT
from repro.optim import AdamW as RAdamW
from repro.optim import cosine_schedule as r_cosine
from repro_torch import configs as TC
from repro_torch import params as P
from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.models import model as TM
from repro_torch.optim import AdamW, cosine_schedule


def _cfgs(arch="smollm-360m"):
    """Reduced configs in f32; MoE drop-free (capacity factor E/K), so
    that no assignment is dropped in either package (where an expert
    overflows, the reference's ``gather`` and ``einsum`` already differ,
    ROADMAP queue 3)."""
    over = dict(dtype="float32")
    cfg = RC.get_config(arch)
    if cfg.num_experts:
        over["capacity_factor"] = cfg.num_experts / cfg.num_experts_per_tok
    r = dataclasses.replace(RC.reduce_config(cfg), **over)
    t = dataclasses.replace(TC.reduce_config(TC.get_config(arch)), **over)
    return r, t


def _params(cfg, seed=0):
    tree = jax.tree.map(np.asarray, RT.init_params(cfg, jax.random.PRNGKey(seed)))
    for layer in tree["layers"]:
        if "wq" not in layer["mixer"]:          # a mamba layer
            continue
        for name in ("wq", "wk", "wv"):
            w = layer["mixer"][name]            # (G, d, H, hd)
            layer["mixer"][name] = w * np.float32((w.shape[-2] / w.shape[1]) ** 0.5)
    return tree, P.from_numpy_tree(tree, device="cpu")


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    mask = (rng.random((B, S)) < 0.9).astype(np.float32)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32), "loss_mask": mask}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _assert_leaves_close(got_tree, want_tree, rel):
    got = jax.tree.leaves(got_tree)
    want = jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= rel * scale, (
            float(np.abs(g - w).max()), scale)


def test_loss_and_every_grad_leaf_match_reference():
    rcfg, tcfg = _cfgs()
    tree, tparams = _params(rcfg)
    batch = _batch(rcfg)
    (rloss, _), rgrads = jax.value_and_grad(
        lambda p: RM.loss_fn(rcfg, p, _jax_batch(batch)), has_aux=True)(
            jax.tree.map(jnp.asarray, tree))
    grads, metrics = TM.make_loss_and_grad(tcfg)(tparams, _torch_batch(batch))
    assert abs(float(metrics["loss"]) - float(rloss)) <= 1e-5
    _assert_leaves_close(P.to_numpy_tree(grads, tcfg),
                         jax.tree.map(np.asarray, rgrads), 1e-4)
    # every leaf carries a gradient: nothing upstream of attention is lost
    assert all(np.abs(g).max() > 0
               for g in jax.tree.leaves(P.to_numpy_tree(grads, tcfg)))


# mamba2 (48 mamba layers cut to 2, SSD chunk 8, so B=2 S=16 runs two
# chunks and the recurrence between them), jamba (16 layers: mamba and
# attention, MoE on odd layers) and the MoE archs.  The reference's
# gradients are finite at these sizes (the SSD chunk is 8: its NaN comes
# only from decays past ~88 within a chunk).  Each leaf within 1e-4 of its
# largest magnitude, as smollm's, except the SSD's per-head dt_bias and
# A_log: the reference sums the log-decay in f32, the port in f64 (about
# 1e-5 apart in every decay), and these two gradients sum that difference
# over every position of every chunk; 5e-4 for them.  Measured with the
# seed below: 2.5e-6 mamba2, 1.6e-4 jamba (its dt_bias; every other leaf
# under 5e-5), 1.1e-6 qwen3-moe and dbrx; the reference's own jit and
# eager gradients differ by up to 1.4e-5.
ARCHS = ["mamba2-1.3b", "jamba-1.5-large-398b", "qwen3-moe-235b-a22b",
         "dbrx-132b"]
SSD_HEAD_LEAVES = ("A_log", "dt_bias")


@pytest.mark.parametrize("arch", ARCHS)
def test_every_layer_kind_trains_and_matches_reference(arch):
    """Loss (the MoE archs' with 0.01 times the aux loss), aux and every
    gradient leaf against ``jax.value_and_grad`` of the reference's
    ``loss_fn``; the port's gradients stacked back to the reference's
    layout, leaf by leaf."""
    rcfg, tcfg = _cfgs(arch)
    tree, tparams = _params(rcfg, seed=7)
    batch = _batch(rcfg, seed=7)
    (rloss, rmetrics), rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(rcfg, p, b), has_aux=True))(
            jax.tree.map(jnp.asarray, tree), _jax_batch(batch))
    grads, metrics = TM.make_loss_and_grad(tcfg)(tparams, _torch_batch(batch))
    assert abs(float(metrics["loss"]) - float(rloss)) <= 1e-5
    assert abs(float(metrics["aux"]) - float(rmetrics["aux"])) <= 1e-5
    assert (float(metrics["aux"]) > 0) == bool(tcfg.num_experts)
    got = P.to_numpy_tree(grads, tcfg)
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, rgrads))
    assert len(jax.tree.leaves(got)) == len(want)
    for g, (path, w) in zip(jax.tree.leaves(got), want):
        name = jax.tree_util.keystr(path)
        tol = 5e-4 if any(k in name for k in SSD_HEAD_LEAVES) else 1e-4
        _assert_leaves_close(g, w, tol)
        assert np.isfinite(g).all() and np.abs(g).max() > 0, name


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_modes_give_the_grads_of_no_remat(remat):
    rcfg, tcfg = _cfgs()
    _, tparams = _params(rcfg, seed=1)
    batch = _torch_batch(_batch(tcfg, seed=1))
    want, _ = TM.make_loss_and_grad(
        dataclasses.replace(tcfg, remat="none"))(tparams, batch)
    got, _ = TM.make_loss_and_grad(
        dataclasses.replace(tcfg, remat=remat))(tparams, batch)
    _assert_leaves_close(P.to_numpy_tree(got, tcfg),
                         P.to_numpy_tree(want, tcfg), 1e-6)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b",
                                  "qwen3-moe-235b-a22b"])
def test_remat_modes_with_ssd_and_moe_give_the_grads_of_no_remat(arch, remat):
    """Each MoE layer's aux loss comes out of its checkpoint: the loss, the
    aux and every gradient (the router's through the Switch loss too) are
    those of remat "none"."""
    rcfg, tcfg = _cfgs(arch)
    _, tparams = _params(rcfg, seed=8)
    batch = _torch_batch(_batch(tcfg, seed=8))
    want, wm = TM.make_loss_and_grad(
        dataclasses.replace(tcfg, remat="none"))(tparams, batch)
    got, gm = TM.make_loss_and_grad(
        dataclasses.replace(tcfg, remat=remat))(tparams, batch)
    assert float(gm["aux"]) == pytest.approx(float(wm["aux"]), abs=1e-6)
    assert float(gm["loss"]) == pytest.approx(float(wm["loss"]), abs=1e-6)
    if tcfg.num_experts:
        assert float(gm["aux"]) > 0
    _assert_leaves_close(P.to_numpy_tree(got, tcfg),
                         P.to_numpy_tree(want, tcfg), 1e-6)


class _GradsOut:
    """An optimizer stand-in whose update returns the gradients in place of
    the grad norm, so a train step's gradients can be compared directly."""

    def update(self, params, grads, state):
        return params, state, grads


def test_microbatches_accumulate_to_the_full_batch_grads():
    rcfg, tcfg = _cfgs()
    tree, tparams = _params(rcfg, seed=2)
    batch = _batch(rcfg, B=4, seed=2)
    batch["loss_mask"][:] = 1.0      # equal denominators in both halves
    full = TM.make_train_step(tcfg, _GradsOut())(tparams, None,
                                                 _torch_batch(batch))[2]
    split = TM.make_train_step(tcfg, _GradsOut(), microbatches=2)(
        tparams, None, _torch_batch(batch))[2]
    assert abs(float(split["loss"]) - float(full["loss"])) <= 1e-5
    _assert_leaves_close(P.to_numpy_tree(split["grad_norm"], tcfg),
                         P.to_numpy_tree(full["grad_norm"], tcfg), 1e-5)
    # and the reference's accumulation, on the same halves
    ref = RM.make_train_step(rcfg, _GradsOut(), microbatches=2)(
        jax.tree.map(jnp.asarray, tree), None, _jax_batch(batch))[2]
    _assert_leaves_close(P.to_numpy_tree(split["grad_norm"], tcfg),
                         jax.tree.map(np.asarray, ref["grad_norm"]), 1e-4)


def test_chunked_lm_loss_matches_reference():
    rcfg, tcfg = _cfgs()
    tree, tparams = _params(rcfg, seed=3)
    rng = np.random.default_rng(3)
    B, S = 2, 16
    hidden = rng.standard_normal((B, S, rcfg.d_model)).astype(np.float32)
    b = _batch(rcfg, B, S, seed=3)
    want = RM.lm_loss(rcfg, jax.tree.map(jnp.asarray, tree),
                      jnp.asarray(hidden), jnp.asarray(b["targets"]),
                      jnp.asarray(b["loss_mask"]), chunk=4)
    h = torch.from_numpy(hidden).requires_grad_()
    args = (torch.from_numpy(b["targets"]), torch.from_numpy(b["loss_mask"]))
    got = TM.lm_loss(tcfg, tparams, h, *args, chunk=4)
    whole = TM.lm_loss(tcfg, tparams, h, *args)
    assert abs(float(got.detach()) - float(want)) <= 1e-5
    assert abs(float(got.detach()) - float(whole.detach())) <= 1e-5
    g_chunked, = torch.autograd.grad(got, h)
    g_whole, = torch.autograd.grad(whole, h)
    np.testing.assert_allclose(g_chunked.numpy(), g_whole.numpy(),
                               atol=1e-7, rtol=1e-5)


def test_same_data_loss_curve_matches_reference():
    """8 train steps of each package from the same params on the same
    batches (the port's loader): the losses agree within 1e-3."""
    _loss_curves_agree("smollm-360m", 8)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "qwen3-moe-235b-a22b"])
def test_same_data_loss_curve_matches_reference_for_ssd_and_moe(arch):
    """The same for 4 steps through the SSD backward and the MoE FFN."""
    _loss_curves_agree(arch, 4)


def _loss_curves_agree(arch, steps):
    rcfg, tcfg = _cfgs(arch)
    tree, tparams = _params(rcfg, seed=4)
    lr = dict(base_lr=3e-3, warmup=2, total=100)
    rstep = jax.jit(RM.make_train_step(rcfg, RAdamW(lr=r_cosine(**lr))))
    topt = AdamW(lr=cosine_schedule(**lr))
    tstep = TM.make_train_step(tcfg, topt)
    rp, ropt = jax.tree.map(jnp.asarray, tree), None
    ropt = RAdamW(lr=r_cosine(**lr)).init(rp)
    tstate = topt.init(tparams)
    loader = ShardedLoader(DataConfig(vocab_size=rcfg.vocab_size, seq_len=32,
                                      global_batch=2, seed=5))
    rl, tl = [], []
    try:
        for _ in range(steps):
            b = next(loader)
            rp, ropt, rm = rstep(rp, ropt, _jax_batch(b))
            tparams, tstate, tm = tstep(tparams, tstate, _torch_batch(b))
            rl.append(float(rm["loss"]))
            tl.append(float(tm["loss"]))
    finally:
        loader.close()
    np.testing.assert_allclose(tl, rl, atol=1e-3, rtol=0)
    assert int(tstate.step) == steps
    _assert_leaves_close(P.to_numpy_tree(tparams, tcfg),
                         jax.tree.map(np.asarray, rp), 1e-3)
