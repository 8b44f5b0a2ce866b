"""The plain references against the port's CPU path at a reduced size, in
float32: the loss and every gradient leaf, the last-token logits, the SSD
scan against its step-by-step recurrence, and AdamW against the port's."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rpexbench import weights as W
from rpexbench.reference import common as R
from rpexbench.tiny import cut

HERE = Path(__file__).resolve().parent
SPEC = json.loads((HERE.parent / "BENCHMARK.json").read_text())


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


# each configuration with its family's reference
CASES = [(c["name"], config(c["name"])["reference"]) for c in SPEC["configs"]]


def tiny_model(name, dtype="float32"):
    m = config(name)["model"]
    m.update(cut("configs", name), dtype=dtype)
    return m


def family(ref):
    import importlib
    return importlib.import_module(f"rpexbench.reference.{ref}")


def batch(m, seed=3, b=2, s=32):
    toks = torch.from_numpy(W.tokens(seed, 1, 0, (b, s + 1), m["vocab_size"]))
    return toks[:, :-1], toks[:, 1:]


@pytest.mark.parametrize("name, ref", CASES)
def test_loss_and_grads_match_the_port(name, ref):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import model as M
    m = tiny_model(name)
    fam = family(ref)
    w = W.draw(fam.leaves(m), 11, "cpu", torch.float32)
    tokens, targets = batch(m)
    grads, met = M.make_loss_and_grad(ModelConfig(**m))(
        w.tree(), {"tokens": tokens, "targets": targets,
                   "loss_mask": torch.ones(targets.shape)})
    params = {p: v.clone().requires_grad_() for p, v in w.views.items()}
    loss = R.loss(fam, m, params, tokens, targets, R.Precision("f32"))
    ref_grads = torch.autograd.grad(loss, list(params.values()))
    assert abs(float(loss.detach()) - float(met["loss"])) < 1e-5
    from rpexbench.workflows import by_path
    for (path, _), g in zip(params.items(), ref_grads):
        mine = by_path(grads, path)
        err = float((mine - g).norm() / g.norm().clamp_min(1e-12))
        assert err < 1e-4, (path, err)


@pytest.mark.parametrize("name, ref", CASES)
def test_last_logits_match_the_port(name, ref):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import model as M
    m = tiny_model(name)
    fam = family(ref)
    w = W.draw(fam.leaves(m), 12, "cpu", torch.float32)
    tokens, _ = batch(m, b=3, s=24)
    logits, _ = M.make_prefill_step(ModelConfig(**m))(w.tree(),
                                                       {"tokens": tokens})
    ref_logits = R.last_logits(fam, m, dict(w.views), tokens,
                               R.Precision("f32"))
    assert torch.allclose(logits[:, 0], ref_logits, atol=2e-5, rtol=1e-5)


def test_ssd_matches_its_recurrence():
    from rpexbench.reference.mamba2 import ssd
    g = torch.Generator().manual_seed(0)
    b, s, h, p, n = 2, 24, 3, 4, 5
    x = torch.randn(b, s, h, p, generator=g)
    dt = torch.rand(b, s, h, generator=g) * 0.5
    A = -torch.rand(h, generator=g) * 4
    B_, C_ = torch.randn(b, s, n, generator=g), torch.randn(b, s, n,
                                                            generator=g)
    state = torch.zeros(b, h, p, n)
    ys = []
    for t in range(s):
        state = (state * torch.exp(dt[:, t] * A)[..., None, None]
                 + torch.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t],
                                B_[:, t]))
        ys.append(torch.einsum("bhpn,bn->bhp", state, C_[:, t]))
    y = ssd(x, dt, A, B_, C_, chunk=8)
    assert torch.allclose(y, torch.stack(ys, 1), atol=1e-5, rtol=1e-5)


def test_adamw_matches_the_port():
    from repro_torch.optim import AdamW, cosine_schedule
    o = json.loads((HERE / "mixes" / "train_workflow.json").read_text())[
        "optimizer"]
    g = torch.Generator().manual_seed(1)
    params = {"embed": torch.randn(6, 4, generator=g),
              "final_norm": torch.randn(4, generator=g),
              "layers": [{"norm1": torch.randn(4, generator=g)}]}
    flat = {"embed": params["embed"], "final_norm": params["final_norm"],
            "layers.0.norm1": params["layers"][0]["norm1"]}
    mine = {k: v.clone() for k, v in flat.items()}
    port = AdamW(lr=cosine_schedule(o["lr"], o["warmup"], o["total"]),
                 b1=o["b1"], b2=o["b2"], eps=o["eps"],
                 weight_decay=o["weight_decay"], clip_norm=o["clip_norm"])
    state = port.init(params)
    ref = R.AdamW(o, {k: torch.float32 for k in flat})
    ref.init(mine)
    for step in range(3):
        grads = {k: torch.randn(v.shape, generator=g) * (step + 1)
                 for k, v in flat.items()}
        tree = {"embed": grads["embed"], "final_norm": grads["final_norm"],
                "layers": [{"norm1": grads["layers.0.norm1"]}]}
        params, state, _ = port.update(params, tree, state)
        ref.update(mine, grads)
    for k in flat:
        np.testing.assert_allclose(mine[k], flat[k], rtol=1e-6, atol=1e-7)


def test_fp8_control_rounds_operands():
    prec = R.Precision("fp8")
    a = torch.linspace(-3, 3, 101)
    q = prec.round(a)
    assert len(torch.unique(q)) < 101 and float((q - a).abs().max()) > 0
    assert torch.equal(R.Precision("f32").round(a), a)
