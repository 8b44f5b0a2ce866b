"""All ten archs through the port, on the CPU.

The first half is tests/test_models_smoke.py run through the port, over
every arch of ``ARCHS``: a forward and a train step (finite loss, a
nonzero grad norm, params moved), token-by-token decode against prefill
at the reference's tolerances (0.1; MoE 0.25; the vlm decode-only), the
init's parameter count against ``cfg.param_count()`` and the 40 cells;
and the serve and train drivers on each reduced config.
Where the reference's test draws with ``jax.random`` (params, tokens), the
same draws are converted through numpy, so that each case is the
reference test's own case.

The second half holds the five archs that no other parity suite covers
against the reference, reduced and in f32: gemma2-9b (local/global
alternation, window, attention and logit caps, tied head), internlm2-1.8b
(untied head), granite-3-2b, musicgen-large (MHA, the non-gated GELU MLP,
an ``audio_stub`` frontend that the model ignores) and internvl2-76b (the
``vision_stub`` connector, the loss over text positions only).  Prefill
logits and caches within 3e-5; decode steps on a shared cache within
3e-5; the loss within 1e-5 and every grad leaf within 1e-4 of its largest
magnitude, as tests/test_torch_train.py holds the other archs.  The
params are the reference's init with wq, wk and wv rescaled to fan_in =
d_model throughout (``_params``), as there.
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
from repro_torch import configs as TC
from repro_torch import params as P
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.optim import AdamW
from repro_torch.tree import leaves

NEW_ARCHS = ["gemma2-9b", "internlm2-1.8b", "granite-3-2b", "musicgen-large",
             "internvl2-76b"]
VLM = "internvl2-76b"
PREFILL_TOL = 3e-5


def _nfe(cfg):
    return cfg.frontend_tokens if cfg.frontend == "vision_stub" else 0


# ----------------- tests/test_models_smoke.py, through the port ------------- #

@pytest.mark.parametrize("arch", RC.ARCHS)
def test_forward_and_train_step(arch):
    """Reduced config in its own dtype (bf16), the port's init: loss finite,
    one AdamW step with a nonzero grad norm that moves the params."""
    cfg = TC.reduce_config(TC.get_config(arch))
    params = TT.init_params(cfg, 0, device="cpu")
    before = [t.clone() for t in leaves(params)]
    rng = np.random.default_rng(0)
    B, S = 2, 16
    nfe = _nfe(cfg)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (B, S - nfe))),
             "targets": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                      (B, S - nfe))),
             "loss_mask": torch.ones((B, S - nfe))}
    if nfe:
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (B, nfe, cfg.d_model), np.float32)).bfloat16()
    with torch.no_grad():
        loss, _ = TM.loss_fn(cfg, params, batch)
    assert loss.shape == () and bool(torch.isfinite(loss)), arch
    opt = AdamW()
    params, _, metrics = TM.make_train_step(cfg, opt)(params, opt.init(params),
                                                      batch)
    assert bool(torch.isfinite(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0
    assert any(bool((a.float() != b.float()).any())
               for a, b in zip(leaves(params), before)), \
        f"{arch}: train step changed nothing"


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_prefill_decode_consistency(arch):
    """The reference's test on its own params and tokens (bf16), run through
    the port: token-by-token decode gives the prefill's last-token logits
    within 0.1 (MoE 0.25: capacity drops differ between the grouped prefill
    and one-token decode) with equal argmax.  The vlm is checked
    decode-only, as the reference checks it: its prefill has the patches
    in front and its decode cache holds text only."""
    cfg = RC.reduce_config(RC.get_config(arch))
    tcfg = TC.reduce_config(TC.get_config(arch))
    key = jax.random.PRNGKey(1)
    params = P.from_numpy_tree(
        jax.tree.map(np.asarray, RT.init_params(cfg, key)), device="cpu")
    B, S = 2, 8
    toks = torch.from_numpy(np.array(
        jax.random.randint(key, (B, S), 0, cfg.vocab_size))).long()
    batch = {"tokens": toks}
    nfe = _nfe(tcfg)
    if nfe:
        batch["patches"] = torch.zeros((B, nfe, tcfg.d_model),
                                       dtype=torch.bfloat16)
    logits_p, _ = TM.make_prefill_step(tcfg)(params, batch)
    assert tuple(logits_p.shape) == (B, 1, cfg.vocab_size)
    decode = TM.make_decode_step(tcfg)
    cache = TT.init_cache(tcfg, B, 32, tcfg.dtype, device="cpu")
    for t in range(S):
        lg, cache = decode(params, toks[:, t:t + 1], cache, t)
    assert tuple(lg.shape) == (B, 1, cfg.vocab_size)
    assert not bool(torch.isnan(lg).any())
    if not nfe:
        tol = 0.25 if cfg.num_experts else 0.1
        np.testing.assert_allclose(lg.float().numpy(),
                                   logits_p.float().numpy(), atol=tol,
                                   rtol=tol)
        assert (lg.argmax(-1) == logits_p.argmax(-1)).all()


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_param_count_matches_init(arch):
    """Reduced: the init's leaves; full width: the spec's shapes (the
    connector included for the vlm)."""
    cfg = TC.reduce_config(TC.get_config(arch))
    params = TT.init_params(cfg, 0, device="cpu")
    assert sum(t.numel() for t in leaves(params)) == cfg.param_count()
    full = TC.get_config(arch)
    assert sum(int(np.prod(shape)) for shape, _ in _spec_leaves(
        TT.param_specs(full))) == full.param_count()


def _spec_leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _spec_leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_serve_and_train_drivers_run(arch, tmp_path):
    """``launch.serve.main`` and ``launch.train.main`` on the reduced config
    with ``--device cpu``: every request answered, two segments of finite
    losses through the runtime (the vlm's batches with patches)."""
    from repro_torch.launch import serve, train
    outputs = serve.main(["--arch", arch, "--reduced", "--requests", "3",
                          "--batch-slots", "2", "--max-ctx", "32",
                          "--max-new", "4", "--device", "cpu"])
    assert len(outputs) == 3 and all(len(v) >= 1 for v in outputs.values())
    losses = train.main(["--arch", arch, "--reduced", "--steps", "2",
                         "--segment", "1", "--batch", "2", "--seq", "16",
                         "--ckpt-every", "2", "--eval-every", "2",
                         "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_cells_cover_40():
    total = sum(len(TC.cells(a)) for a in TC.ARCHS)
    assert total == 40
    runs = sum(1 for a in TC.ARCHS for _, s in TC.cells(a) if s == "RUN")
    assert runs == 33 and total - runs == 7


# ----------------------- the five archs, against the reference ------------------ #

def _cfgs(arch):
    r = dataclasses.replace(RC.reduce_config(RC.get_config(arch)),
                            dtype="float32")
    t = dataclasses.replace(TC.reduce_config(TC.get_config(arch)),
                            dtype="float32")
    return r, t


def _params(cfg, seed):
    """The reference's init, wq, wk and wv rescaled to fan_in = d_model, as
    numpy and as the port's params.  At the reference's own init the
    prefill logits of the two packages differ by up to 3.6e-5 (internvl2,
    musicgen), rescaled by under 2e-6 (relative to 1 + |logit|), so the
    3e-5 tolerance can tell a fault from rounding."""
    tree = jax.tree.map(np.asarray, RT.init_params(cfg, jax.random.PRNGKey(seed)))
    for layer in tree["layers"]:
        for name in ("wq", "wk", "wv"):
            w = layer["mixer"][name]                # (G, d, H, hd)
            layer["mixer"][name] = w * np.float32(
                (w.shape[-2] / w.shape[1]) ** 0.5)
    return tree, P.from_numpy_tree(tree, device="cpu")


def _batch(cfg, B=2, S=16, seed=0):
    """Tokens, targets and a loss mask of S text positions; for the vlm,
    ``frontend_tokens`` patches in front."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    b = {"tokens": toks[:, :-1].astype(np.int32),
         "targets": toks[:, 1:].astype(np.int32),
         "loss_mask": (rng.random((B, S)) < 0.9).astype(np.float32)}
    if _nfe(cfg):
        b["patches"] = rng.standard_normal(
            (B, _nfe(cfg), cfg.d_model)).astype(np.float32)
    return b


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _close_caches(tcache, rcache, tcfg, tol):
    got = P.cache_to_numpy(tcache, tcfg)
    assert len(got) == len(rcache)
    for tc, rc in zip(got, rcache):
        for t, r in zip(tc, rc):
            assert t.shape == r.shape
            _close(t, r, tol)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_matches_reference(arch):
    """Last-token logits and every layer's cache (the vlm's with its patch
    positions in front); gemma2's 16 positions pass its reduced window of
    8, so the local layers' window cuts."""
    cfg, tcfg = _cfgs(arch)
    tree, tparams = _params(cfg, 0)
    b = _batch(cfg, S=16, seed=1)
    del b["targets"], b["loss_mask"]
    rlogits, rcache = RM.make_prefill_step(cfg)(jax.tree.map(jnp.asarray, tree),
                                                _jax(b))
    tlogits, tcache = TM.make_prefill_step(tcfg)(tparams, _torch(b))
    assert tuple(tlogits.shape) == (2, 1, cfg.vocab_size)
    _close(tlogits, rlogits, PREFILL_TOL)
    assert tcache[0].k.shape[1] == 16 + _nfe(cfg)
    _close_caches(tcache, rcache, tcfg, PREFILL_TOL)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_decode_steps_match_reference_on_shared_cache(arch):
    """5 decode steps from one random cache of 16 positions, at positions 3
    to 11: gemma2's local layers mask by their window of 8 from position
    8 on."""
    cfg, tcfg = _cfgs(arch)
    tree, tparams = _params(cfg, 1)
    B, steps = 2, 5
    rng = np.random.default_rng(3)
    specs = RT.cache_specs(cfg, B, 16, "float32")
    cache_np = [tuple(rng.standard_normal(s.shape).astype(np.float32)
                      for s in spec) for spec in specs]
    rcache = [type(spec)(*map(jnp.asarray, c))
              for spec, c in zip(specs, cache_np)]
    tcache = P.cache_from_numpy(cache_np, device="cpu")
    rdecode = jax.jit(RM.make_decode_step(cfg))
    rparams = jax.tree.map(jnp.asarray, tree)
    tdecode = TM.make_decode_step(tcfg)
    toks = rng.integers(0, cfg.vocab_size, (B, steps))
    for t in range(steps):
        pos = 3 + 2 * t
        rl, rcache = rdecode(rparams, jnp.asarray(toks[:, t:t + 1]), rcache,
                             jnp.int32(pos))
        tl, tcache = tdecode(tparams, torch.from_numpy(toks[:, t:t + 1]),
                             tcache, pos)
        _close(tl, rl, PREFILL_TOL)
    _close_caches(tcache, rcache, tcfg, PREFILL_TOL)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_loss_and_every_grad_leaf_match_reference(arch):
    """``jax.value_and_grad`` of the reference's ``loss_fn`` against the
    port's ``make_loss_and_grad``: the vlm with patches, so the connector's
    two leaves carry gradients too."""
    cfg, tcfg = _cfgs(arch)
    tree, tparams = _params(cfg, 7)
    b = _batch(cfg, seed=7)
    (rloss, _), rgrads = jax.value_and_grad(
        lambda p: RM.loss_fn(cfg, p, _jax(b)), has_aux=True)(
            jax.tree.map(jnp.asarray, tree))
    grads, metrics = TM.make_loss_and_grad(tcfg)(tparams, _torch(b))
    assert abs(float(metrics["loss"]) - float(rloss)) <= 1e-5
    got = P.to_numpy_tree(grads, tcfg)
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, rgrads))
    assert len(jax.tree.leaves(got)) == len(want)
    for g, (path, w) in zip(jax.tree.leaves(got), want):
        name = jax.tree_util.keystr(path)
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= 1e-4 * scale, name
        assert np.isfinite(g).all() and np.abs(g).max() > 0, name


def test_vlm_loss_is_over_text_positions_only():
    """internvl2 with patches: the loss is ``lm_loss`` over the hidden
    states of the text positions alone (the prefix of patch positions cut
    away), the reference's value; the connector's grads are nonzero and
    the reference's; and without patches the model is the text model."""
    cfg, tcfg = _cfgs(VLM)
    tree, tparams = _params(cfg, 9)
    b = _batch(cfg, seed=9)
    nfe = b["patches"].shape[1]
    tb = _torch(b)
    with torch.no_grad():
        loss, _ = TM.loss_fn(tcfg, tparams, tb)
        x = TM.embed_inputs(tcfg, tparams, tb)
        assert tuple(x.shape) == (2, nfe + 16, cfg.d_model)
        hidden, _, _ = TT.forward(tcfg, tparams, x, mode="train")
        text = TM.lm_loss(tcfg, tparams, hidden[:, nfe:], tb["targets"],
                          tb["loss_mask"])
        no_patches = TM.loss_fn(tcfg, tparams, {k: v for k, v in tb.items()
                                                if k != "patches"})[0]
    assert float(loss) == float(text)
    assert float(loss) != float(no_patches)     # the patches reach the text
    rloss, _ = RM.loss_fn(cfg, jax.tree.map(jnp.asarray, tree), _jax(b))
    assert abs(float(loss) - float(rloss)) <= 1e-5
    rgrads = jax.grad(lambda p: RM.loss_fn(cfg, p, _jax(b))[0])(
        jax.tree.map(jnp.asarray, tree))
    grads, _ = TM.make_loss_and_grad(tcfg)(tparams, tb)
    for name in ("wi", "wo"):
        g = grads["connector"][name].numpy()
        w = np.asarray(rgrads["connector"][name])
        assert np.abs(g).max() > 0
        assert float(np.abs(g - w).max()) <= 1e-4 * float(np.abs(w).max())


def test_connector_spec_and_init_follow_the_reference():
    """The connector's two (d, d) leaves carry the reference's axes, and
    ``init_params`` draws them with fan_in = d: std d^-1/2."""
    full_r, full_t = RC.get_config(VLM), TC.get_config(VLM)
    assert TT.param_specs(full_t)["connector"] == \
        RT.param_specs(full_r)["connector"]
    cfg = dataclasses.replace(TC.reduce_config(full_t), d_model=256,
                              dtype="float32")
    conn = TT.init_params(cfg, 3, device="cpu")["connector"]
    for name in ("wi", "wo"):
        w = conn[name]
        assert tuple(w.shape) == (256, 256)
        assert abs(float(w.std()) * 16.0 - 1.0) < 0.03, float(w.std())
    assert "connector" not in TT.param_specs(TC.get_config("musicgen-large"))


def test_audio_stub_ignores_frontend_tokens():
    """``reduce_config`` gives musicgen's ``audio_stub`` frontend_tokens=4;
    the reference ignores it and any patches outside ``vision_stub``, and
    so does the port: the same logits with and without a patches key,
    the reference's."""
    cfg, tcfg = _cfgs("musicgen-large")
    assert tcfg.frontend == "audio_stub" and tcfg.frontend_tokens == 4
    tree, tparams = _params(cfg, 2)
    b = _batch(cfg, S=12, seed=2)
    b = {"tokens": b["tokens"], "patches": np.ones((2, 4, cfg.d_model),
                                                   np.float32)}
    prefill = TM.make_prefill_step(tcfg)
    with_p, cache = prefill(tparams, _torch(b))
    without, _ = prefill(tparams, {"tokens": torch.from_numpy(b["tokens"])})
    assert cache[0].k.shape[1] == 12
    assert torch.equal(with_p, without)
    rlogits, _ = RM.make_prefill_step(cfg)(jax.tree.map(jnp.asarray, tree),
                                           _jax(b))
    _close(with_p, rlogits, PREFILL_TOL)
