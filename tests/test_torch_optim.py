"""The port's AdamW and cosine schedule against the reference's.

Ports of the four AdamW tests of tests/test_substrate.py, then N steps of
both optimizers on the same params and gradients (numpy, from a seed), with
f32 and bf16 moments, in the reference's layout on its side and the port's
per-layer layout on the other (a layer's norm scale decays in both, as a
stacked (G, d) leaf does in the reference).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamW as RAdamW
from repro.optim import cosine_schedule as r_cosine
from repro_torch.optim import AdamW, cosine_schedule


def test_adamw_converges_on_quadratic():
    opt = AdamW(lr=lambda s: 0.1, weight_decay=0.0, clip_norm=100.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = opt.update(params, grads, state)
    assert float(params["w"].abs().max()) < 1e-2


def test_adamw_grad_clipping():
    opt = AdamW(lr=lambda s: 1e-3, clip_norm=1.0)
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    _, _, gnorm = opt.update(params, {"w": torch.full((3,), 1e6)}, state)
    assert float(gnorm) > 1e5      # reported norm is pre-clip


def test_adamw_bf16_states():
    opt = AdamW(state_dtype="bfloat16")
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    st_ = opt.init(params)
    assert st_.m["w"].dtype == torch.bfloat16
    p2, st2, _ = opt.update(params, {"w": torch.ones((4, 4),
                                                      dtype=torch.bfloat16)},
                            st_)
    assert st2.v["w"].dtype == torch.bfloat16
    assert p2["w"].dtype == torch.bfloat16


def test_cosine_schedule():
    lr = cosine_schedule(1.0, 10, 100)
    assert float(lr(0)) == 0.0
    assert abs(float(lr(10)) - 1.0) < 1e-6
    assert float(lr(100)) < 1e-6


def test_cosine_schedule_matches_reference():
    for args in ((3e-4, 20, 10_000), (1.0, 10, 100), (2e-3, 0, 50)):
        ref, port = r_cosine(*args), cosine_schedule(*args)
        for step in (0, 1, 5, 10, 19, 20, 21, 50, 99, 100, 5000, 20_000):
            assert float(port(torch.tensor(step, dtype=torch.int32))) == \
                float(ref(jnp.int32(step))), (args, step)


G, D, F = 2, 6, 5


def _ref_tree(rng):
    """The reference's layout: layer leaves stacked (G, ...)."""
    return {"embed": rng.standard_normal((7, D)).astype(np.float32),
            "final_norm": rng.standard_normal(D).astype(np.float32),
            "layers": [{"norm1": rng.standard_normal((G, D)).astype(np.float32),
                        "w": rng.standard_normal((G, D, F)).astype(np.float32)}]}


def _port_tree(tree, dtype):
    conv = lambda a: torch.from_numpy(np.array(a)).to(dtype)
    return {"embed": conv(tree["embed"]), "final_norm": conv(tree["final_norm"]),
            "layers": [{k: conv(v[g]) for k, v in tree["layers"][0].items()}
                       for g in range(G)]}


def _port_to_ref(tree):
    num = lambda t: t.float().numpy()
    return {"embed": num(tree["embed"]), "final_norm": num(tree["final_norm"]),
            "layers": [{k: np.stack([num(l[k]) for l in tree["layers"]])
                        for k in tree["layers"][0]}]}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_steps_match_reference(state_dtype):
    rng = np.random.default_rng(0)
    tree = _ref_tree(rng)
    kw = dict(weight_decay=0.1, clip_norm=1.0, state_dtype=state_dtype)
    ropt = RAdamW(lr=r_cosine(1e-2, 2, 20), **kw)
    topt = AdamW(lr=cosine_schedule(1e-2, 2, 20), **kw)
    rp = jax.tree.map(jnp.asarray, tree)
    rs = ropt.init(rp)
    tp = _port_tree(tree, torch.float32)
    ts = topt.init(tp)
    for _ in range(6):
        grads = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.3, tree)
        rp, rs, rn = ropt.update(rp, jax.tree.map(jnp.asarray, grads), rs)
        tp, ts, tn = topt.update(tp, _port_tree(grads, torch.float32), ts)
        assert abs(float(tn) - float(rn)) <= 1e-6 * float(rn)
    assert int(ts.step) == int(rs.step) == 6
    tol = 1e-6 if state_dtype == "float32" else 1e-5
    for got, want in ((tp, rp), (ts.m, rs.m), (ts.v, rs.v)):
        for g, w in zip(jax.tree.leaves(_port_to_ref(got)),
                        jax.tree.leaves(jax.tree.map(
                            lambda a: np.asarray(a, np.float32), want))):
            np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


def test_adamw_updates_a_large_leaf_in_slices_bitwise(monkeypatch):
    """A leaf above ``_SLICE`` elements is updated in flat slices (so that
    the f32 temporaries of an MoE expert leaf do not all live at once);
    params and moments come out bitwise as from the whole-leaf update, a
    non-contiguous leaf falls back to the whole, and small leaves are
    untouched by the slicing."""
    from repro_torch.optim import adamw
    rng = np.random.default_rng(0)
    draw = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    params = {"w": draw(300, 50).bfloat16(), "b": draw(7),
              "t": draw(50, 40).T, "layers": [{"x": draw(40, 30)}]}
    grads = {"w": draw(300, 50).bfloat16(), "b": draw(7),
             "t": draw(40, 50), "layers": [{"x": draw(40, 30)}]}
    out = []
    for piece in (1 << 26, 1000):
        monkeypatch.setattr(adamw, "_SLICE", piece)
        p = {k: (v.clone() if torch.is_tensor(v) else [{"x": v[0]["x"].clone()}])
             for k, v in params.items()}
        opt = AdamW(lr=cosine_schedule(1e-2, 1, 100))
        state = opt.init(p)
        for _ in range(3):
            p, state, _ = opt.update(p, grads, state)
        out.append((p, state))
    (a, sa), (b, sb) = out
    for x, y in ((a, b), (sa.m, sb.m), (sa.v, sb.v)):
        for k in ("w", "b", "t"):
            assert torch.equal(x[k], y[k]), k
        assert torch.equal(x["layers"][0]["x"], y["layers"][0]["x"])
    assert not torch.equal(a["w"], params["w"])
