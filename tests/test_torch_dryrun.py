"""The dry-run (``repro_torch.launch.dryrun``) and what it is built on.

* ``input_specs``, ``input_axes``, ``auto_microbatches``,
  ``abstract_params``, ``cache_specs`` and ``AdamW.abstract_state`` /
  ``state_axes`` for every arch and shape at full width, against the
  reference's shapes, dtypes and axes (the port's layers restacked
  through ``repro_torch.params.stack_layers``, or compared layer by layer
  with the reference's ``"layers"`` axis dropped).
* A copy of the reference's ``test_dryrun_artifacts_complete``
  (``tests/test_system.py``) against the port's dry-run: all 40 cells on
  the 16 x 16 fake world at full width, ``--cfg-json`` cutting each arch's
  depth to one program period, in a subprocess (the fake world never
  reaches a pytest worker); each cell ``ok`` or ``SKIP(full-attn)``, and a
  cell counted three times in a row counts the same.
* The model-sharded train step on gloo worlds of CPU processes
  (``tests/_torch_dist.py``), against the unsharded step with the bounds
  of ``test_sharded_train_step_matches_unsharded``: a vocab split over
  the model axis (DTensor's own vocab-split embedding gives a gradient it
  cannot place) and smollm's 15 q and 5 kv heads on a (2, 4) mesh
  (DTensor's einsum for the output projection cannot unflatten its heads
  in the backward); and the same cases' loss and gathered grads, leaf by
  leaf, against the unsharded port's and the reference's.
"""
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_dist as D
import test_torch_train as TT
from repro import configs as RC
from repro.models import model as RM
from repro.models import transformer as RT
from repro.optim import AdamW as RAdamW
from repro_torch import configs as TC
from repro_torch import params as P
from repro_torch.models import model as TM
from repro_torch.models import transformer as TTr
from repro_torch.optim import AdamW

REPO = Path(__file__).resolve().parents[1]
ARCHS = list(TC.ARCHS)
SHAPES = list(TC.SHAPES)


def _dtype(x):
    """A jax or torch dtype's name: "int32", "bfloat16", ..."""
    return str(x).split(".")[-1]


def _sig(tree):
    """Shapes and dtypes of a tree of arrays, tensors or ShapeDtypeStructs,
    leaf for leaf."""
    return [(tuple(a.shape), _dtype(a.dtype)) for a in jax.tree.leaves(
        jax.tree.map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape),
                                                    _dtype(t.dtype)), tree,
                     is_leaf=lambda t: isinstance(t, torch.Tensor)))]


def _stacked(tree, cfg):
    return P.stack_layers(tree, cfg)


# ------------------------ specs against the reference -------------------- #

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape_name", SHAPES)
def test_input_specs_and_axes_match_reference(arch, shape_name):
    rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    rshape, tshape = RC.get_shape(shape_name), TC.get_shape(shape_name)
    want, got = RM.input_specs(rcfg, rshape), TM.input_specs(tcfg, tshape)
    want_ax, got_ax = RM.input_axes(rcfg, rshape), TM.input_axes(tcfg, tshape)
    assert sorted(want) == sorted(got) == sorted(want_ax) == sorted(got_ax)
    for n in (1, 16, 32):
        assert TM.auto_microbatches(tcfg, tshape, n) == \
            RM.auto_microbatches(rcfg, rshape, n)
    if tshape.kind != "decode":
        for k, t in got.items():
            assert t.device.type == "meta"
            assert (tuple(t.shape), _dtype(t.dtype)) == \
                (tuple(want[k].shape), _dtype(want[k].dtype)), k
        assert got_ax == want_ax
        return
    assert got["pos"] == tshape.seq_len - 1 and want["pos"].shape == ()
    assert got_ax["pos"] == want_ax["pos"] == ()
    assert (tuple(got["token"].shape), _dtype(got["token"].dtype)) == \
        (tuple(want["token"].shape), _dtype(want["token"].dtype))
    assert got_ax["token"] == want_ax["token"]
    # the cache: one entry per layer, the reference's stacked per period
    period = len(want["cache"])
    assert len(got["cache"]) == tcfg.num_layers
    for i, (entry, axes) in enumerate(zip(got["cache"], got_ax["cache"])):
        ref, ref_ax = want["cache"][i % period], want_ax["cache"][i % period]
        assert type(entry).__name__ == type(ref).__name__
        for t, ax, r, rax in zip(entry, axes, ref, ref_ax):
            assert t.device.type == "meta"
            assert ((tcfg.num_layers // period,) + tuple(t.shape),
                    _dtype(t.dtype)) == (tuple(r.shape), _dtype(r.dtype))
            assert ("layers",) + tuple(ax) == tuple(rax)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_state_match_reference(arch):
    """Params and AdamW state as meta tensors, restacked, leaf for leaf
    the reference's ShapeDtypeStructs; the step a real int32 host tensor;
    the state's axes the params' (the reference's with "layers")."""
    rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    p_ref, p_got = RT.abstract_params(rcfg), TTr.abstract_params(tcfg)
    assert all(t.device.type == "meta" for t in jax.tree.leaves(
        p_got, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert _sig(_stacked(p_got, tcfg)) == _sig(p_ref)
    assert _sig(_stacked(TTr.abstract_params(tcfg, "float32"), tcfg)) == \
        _sig(RT.abstract_params(rcfg, "float32"))
    state_dtype = "bfloat16" if rcfg.param_count() >= 100e9 else "float32"
    s_ref = RAdamW(state_dtype=state_dtype).abstract_state(p_ref)
    s_got = AdamW(state_dtype=state_dtype).abstract_state(p_got)
    assert s_got.step.device.type == "cpu" and s_got.step.dtype == torch.int32
    assert int(s_got.step) == 0 and s_ref.step.shape == ()
    for got, want in ((s_got.m, s_ref.m), (s_got.v, s_ref.v)):
        assert _sig(_stacked(got, tcfg)) == _sig(want)
    ax_ref = RAdamW().state_axes(RT.param_axes(rcfg))
    ax_got = AdamW().state_axes(TTr.param_axes(tcfg))
    assert ax_got.step == ax_ref.step == ()
    assert ax_got.m is ax_got.v is not None
    period = len(ax_ref.m["layers"])
    for i, layer in enumerate(ax_got.m["layers"]):
        want = ax_ref.m["layers"][i % period]
        flat_got = jax.tree.leaves(layer, is_leaf=lambda x: isinstance(
            x, tuple))
        flat_want = jax.tree.leaves(want, is_leaf=lambda x: isinstance(
            x, tuple))
        assert [("layers",) + tuple(a) for a in flat_got] == \
            [tuple(a) for a in flat_want]
    for k in ax_got.m:
        if k != "layers":
            assert ax_got.m[k] == ax_ref.m[k]


# ------------------------- the dry-run's artifacts ----------------------- #

_SWEEP = r"""
import json, sys
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun
from repro_torch.models.transformer import program_period
out = sys.argv[1]
for arch in ARCHS:
    period = program_period(get_config(arch))
    dryrun.main(["--all", "--arch", arch, "--out", out,
                 "--cfg-json", json.dumps({"num_layers": period})])
# smollm's train cell (the model-sharded path) at two layers,
# counted three times in a row
name, mesh = dryrun.mesh_for()
cell = dryrun.build_cell("smollm-360m", "train_4k", mesh,
                         cfg_overrides={"num_layers": 2})
counts = [dryrun.count_cell(*cell[2:])[0] for _ in range(3)]
print("COUNTS" + json.dumps(counts))
"""


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", _SWEEP, str(out)],
                       capture_output=True, text=True, env=env,
                       cwd=str(REPO), timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return out, json.loads(r.stdout.split("COUNTS")[1])


def test_dryrun_artifacts_complete(sweep):
    """All 40 cells of the 16 x 16 mesh: each ok or SKIP(full-attn), with
    FLOPs and a peak counted (the reference's test, against the port)."""
    base, _ = sweep
    files = list((base / "pod16x16").glob("*.json"))
    assert len(files) == 40, f"pod16x16: {len(files)} cells"
    skipped = set()
    for f in files:
        a = json.loads(f.read_text())
        assert a["status"] in ("ok", "SKIP(full-attn)"), \
            f"{f.name}: {a.get('status')} {a.get('error', '')[:200]}"
        if a["status"] == "ok":
            assert a["cost"]["flops_per_device"] > 0
            assert a["peak_bytes_per_device"] > 0
        else:
            skipped.add((a["arch"], a["shape"]))
    assert skipped == {(arch, "long_500k") for arch in ARCHS
                       if arch not in TC.LONG_CONTEXT_OK}


REF_KEYS = {"status", "n_chips", "memory", "peak_bytes_per_device", "cost",
            "collectives", "model_flops_global", "microbatches", "params",
            "active_params", "tokens", "roofline"}


def test_dryrun_artifact_keys_and_terms(sweep):
    """The reference's keys, the H100 model named, the roofline terms from
    the counts, every kernel of the cell counted by its formula."""
    base, _ = sweep
    a = json.loads((base / "pod16x16" / "gemma2-9b__train_4k.json").read_text())
    assert REF_KEYS <= set(a) and {"fits_80GB", "trace_s"} <= set(a)
    assert a["n_chips"] == 256 and a["counted_rank"] == 255
    assert a["hardware"]["name"] == "NVIDIA H100 SXM data sheet"
    assert a["hardware"]["peak_flops"] == 989e12
    r = a["roofline"]
    assert r["compute_s"] == a["cost"]["flops_per_device"] / 989e12
    assert r["memory_s"] == a["cost"]["bytes_per_device"] / 3.35e12
    assert r["collective_s"] == a["collectives"]["seconds"] > 0
    assert set(a["cost"]["kernels"]) == {"flash_attention_fwd",
                                         "flash_attention_bwd"}
    cut = dataclasses.replace(TC.get_config("gemma2-9b"), num_layers=2)
    assert a["num_layers"] == 2
    assert a["model_flops_global"] == \
        cut.model_flops_per_token(True) * 256 * 4096
    m = json.loads((base / "pod16x16" / "mamba2-1.3b__train_4k.json"
                    ).read_text())
    assert set(m["cost"]["kernels"]) == {"ssd_chunk_kernel",
                                         "ssd_chunk_bwd_kernel",
                                         "ssd_pass_kernel",
                                         "ssd_pass_bwd_kernel"}


def test_report_reads_every_cell(sweep, capsys):
    """``python -m repro_torch.roofline.report``'s table and CSV over the
    sweep: one row per cell, the skipped ones marked."""
    from repro_torch.roofline import report
    base, _ = sweep
    rows = report.main(["--mesh", "pod16x16", "--dir", str(base)])
    table = capsys.readouterr().out.splitlines()
    assert len(rows) == 40 and len(table) == 41
    assert sum(r["status"] == "ok" for r in rows) == 40 - 7
    assert all(r["fits"] in (True, False) for r in rows if r["status"] == "ok")
    csv = report.main(["--mesh", "pod16x16", "--dir", str(base), "--csv"])
    lines = capsys.readouterr().out.splitlines()
    assert len(csv) == 40 and len(lines) == 41
    assert lines[0].endswith("fits_80GB,mu")


def test_dryrun_counts_repeat_exactly(sweep):
    _, counts = sweep
    first, second, third = counts
    assert first["flops"] > 0 and first["collectives"]
    assert first == second == third


# --------------- the model-sharded train step, vocab and heads split ------ #

def _step_case(arch, **over):
    rcfg, _ = TT._cfgs(arch)
    over = dict(num_layers=2, **over)
    rcfg = dataclasses.replace(rcfg, **over)
    over["dtype"] = "float32"
    if rcfg.num_experts:
        over["capacity_factor"] = rcfg.capacity_factor
    tree, _ = TT._params(rcfg, 0)
    return rcfg, over, tree, TT._batch(rcfg, B=4, S=16)


SPLIT_CASES = {
    "smollm-vocab/1x2": ("smollm-360m", {"vocab_size": 256},
                         {"data": 1, "model": 2}),
    "qwen3-moe-vocab/1x2": ("qwen3-moe-235b-a22b", {"vocab_size": 256},
                            {"data": 1, "model": 2}),
    "smollm-vocab/2x2": ("smollm-360m", {"vocab_size": 256},
                         {"data": 2, "model": 2}),
    "smollm-heads/2x4": ("smollm-360m", {"num_heads": 15, "num_kv_heads": 5},
                         {"data": 2, "model": 4}),
}


@pytest.fixture(scope="module")
def split_steps(tmp_path_factory):
    """Each case's sharded train step (one AdamW step) and its loss and
    gathered grads, in gloo worlds of 2, 4 and 8 ranks, run at once."""
    by_world = {}
    for name, (arch, over, dims) in SPLIT_CASES.items():
        _, over_, tree, batch = _step_case(arch, **over)
        n = int(np.prod(list(dims.values())))
        jobs = by_world.setdefault(n, {})
        jobs[name] = (D.model_loss_and_grads,
                      (arch, over_, dims, tree, batch, 1))
        jobs[f"{name}/grads"] = (D.model_loss_and_grads,
                                 (arch, over_, dims, tree, batch))
    tmp = tmp_path_factory.mktemp("split_steps")
    with concurrent.futures.ThreadPoolExecutor(len(by_world)) as pool:
        futs = [pool.submit(D.run_world, D.run_jobs, n, tmp, jobs,
                            timeout=240) for n, jobs in by_world.items()]
        out = {}
        for f in futs:
            out.update(f.result()[0])
    return out


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_vocab_and_heads_train_step_matches_unsharded(split_steps,
                                                            case):
    """The sharded step against the unsharded port's step: grad_norm
    within 1e-5 relative, the loss within 1e-5 (and within 1e-5 of the
    reference's unsharded loss), each updated param leaf within 1e-4 of
    its largest magnitude; params and moments stay DTensors."""
    import jax.numpy as jnp
    arch, over, dims = SPLIT_CASES[case]
    rcfg, over_, tree, batch = _step_case(arch, **over)
    tcfg = D._port_cfg(arch, over_)
    opt = AdamW()
    params = P.from_numpy_tree(tree, device="cpu")
    step = TM.make_train_step(tcfg, opt)
    params, _, metrics = step(params, opt.init(params),
                              TT._torch_batch(batch))
    got = split_steps[case]
    assert got["dtensor"]
    assert got["metrics"]["grad_norm"] == pytest.approx(
        float(metrics["grad_norm"]), rel=1e-5)
    assert abs(got["metrics"]["loss"] - float(metrics["loss"])) <= 1e-5
    rloss, _ = RM.loss_fn(rcfg, jax.tree.map(jnp.asarray, tree),
                          TT._jax_batch(batch))
    assert abs(got["metrics"]["loss"] - float(rloss)) <= 1e-5
    for g, w in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(P.to_numpy_tree(params, tcfg))):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= 1e-4 * scale, case


def _normwise(got, want, rel, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.linalg.norm(got - want))
    scale = max(float(np.linalg.norm(want)), 1e-30)
    assert err <= rel * scale, (what, err / scale)


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_vocab_and_heads_grads_match_unsharded(split_steps, case):
    """The sharded loss and grads, gathered, against the unsharded port's
    and the reference's ``jax.value_and_grad`` of ``loss_fn``: the loss
    and aux within 1e-5, and each grad leaf normwise (the norm of the
    difference over the norm of the unsharded leaf) within 1e-5 of both
    (readings at most 1.1e-6 and 1.4e-6): a leaf's gradient dropped,
    doubled or of the wrong sign reads 1 or 2."""
    import jax.numpy as jnp
    arch, over, dims = SPLIT_CASES[case]
    rcfg, over_, tree, batch = _step_case(arch, **over)
    tcfg = D._port_cfg(arch, over_)
    (rloss, _), rgrads = jax.value_and_grad(
        lambda p: RM.loss_fn(rcfg, p, TT._jax_batch(batch)), has_aux=True)(
            jax.tree.map(jnp.asarray, tree))
    grads, metrics = TM.make_loss_and_grad(tcfg)(
        P.from_numpy_tree(tree, device="cpu"), TT._torch_batch(batch))
    got = split_steps[f"{case}/grads"]
    assert got["dtensor"]
    assert abs(got["loss"] - float(rloss)) <= 1e-5
    assert abs(got["loss"] - float(metrics["loss"])) <= 1e-5
    assert abs(got["aux"] - float(metrics["aux"])) <= 1e-5
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_leaves_with_path(got["grads"])]
    for name, g, w, m in zip(
            names, jax.tree.leaves(got["grads"]),
            jax.tree.leaves(jax.tree.map(np.asarray, rgrads)),
            jax.tree.leaves(P.to_numpy_tree(grads, tcfg))):
        _normwise(g, m, 1e-5, (case, name, "port"))
        _normwise(g, w, 1e-5, (case, name, "reference"))
