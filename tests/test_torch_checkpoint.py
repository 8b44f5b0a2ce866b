"""The port's checkpointer: ports of the five checkpoint tests of
tests/test_substrate.py, cross-restore with the reference's ``Checkpointer``
in both directions on the train driver's tree (params, AdamState, data
cursor) of reduced smollm-360m in bf16, and a run with ``ml_dtypes``
blocked from import (the machine with the card has no JAX, so no
``ml_dtypes``)."""
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import Checkpointer as RCheckpointer
from repro.configs import get_config as r_get_config
from repro.configs import reduce_config as r_reduce
from repro.models import transformer as RT
from repro.optim import AdamState as RAdamState
from repro_torch import params as P
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduce_config
from repro_torch.launch.train import checkpoint_tree
from repro_torch.models import transformer as TT
from repro_torch.optim import AdamState, AdamW

REPO = Path(__file__).resolve().parents[1]


def test_checkpoint_roundtrip_bf16(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"a": torch.ones((3, 4), dtype=torch.bfloat16) * 1.5,
            "b": {"c": torch.arange(5, dtype=torch.int32)},
            "d": np.float64(3.25)}
    ck.save(7, tree)
    step, out = ck.restore(tree)
    assert step == 7
    assert out["a"].dtype == torch.bfloat16
    assert torch.equal(out["a"], tree["a"])
    assert torch.equal(out["b"]["c"], tree["b"]["c"])


def test_checkpoint_float64_host_leaf_keeps_dtype(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"host": np.linspace(0, 1, 7, dtype=np.float64),
            "scalar": np.float64(2.5),
            "dev": torch.arange(4, dtype=torch.float32)}
    ck.save(3, tree)
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        step, out = ck.restore(tree)
    assert step == 3
    assert isinstance(out["host"], np.ndarray)
    assert out["host"].dtype == np.float64
    np.testing.assert_array_equal(out["host"], tree["host"])
    assert np.asarray(out["scalar"]).dtype == np.float64
    assert float(out["scalar"]) == 2.5
    assert out["dev"].dtype == torch.float32            # tensor leaf intact
    assert torch.equal(out["dev"], tree["dev"])


def test_checkpoint_gc_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    t = {"x": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        ck.save(s, t)
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4


def test_checkpoint_async_and_atomic(tmp_path):
    ck = Checkpointer(str(tmp_path))
    x = torch.ones(1000)
    ck.save_async(1, {"x": x})
    x.add_(1)                    # the snapshot was taken before this
    ck.wait()
    assert ck.latest_step() == 1
    assert not list(tmp_path.glob("*.tmp"))
    assert torch.equal(ck.restore({"x": x})[1]["x"], torch.ones(1000))


def test_checkpoint_structure_mismatch_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"x": torch.zeros(2)})
    with pytest.raises(ValueError):
        ck.restore({"x": torch.zeros(2), "y": torch.zeros(2)})


def _state(seed):
    """The reference's (params, AdamState, cursor) of reduced smollm in bf16,
    moments f32 and nonzero, as numpy-backed JAX arrays."""
    cfg = r_reduce(r_get_config("smollm-360m"))
    params = RT.init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    rand = lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32)
    opt = RAdamState(jnp.asarray(7, jnp.int32), jax.tree.map(rand, params),
                     jax.tree.map(rand, params))
    return params, opt, np.int64(12345 + seed)


def _port_like(tcfg):
    params = TT.init_params(tcfg, 0, device="cpu")
    return params, AdamW().init(params)


def _assert_same(port, ref):
    """port: (params, AdamState, cursor) in the port's layout."""
    tcfg = reduce_config(get_config("smollm-360m"))
    params, opt, cursor = port
    rparams, ropt, rcursor = ref
    for got, want in ((P.to_numpy_tree(params, tcfg), rparams),
                      (P.opt_state_to_numpy(opt, tcfg), tuple(ropt))):
        gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
        assert len(gl) == len(wl)
        for g, w in zip(gl, wl):
            np.testing.assert_array_equal(np.asarray(g, np.float32),
                                          np.asarray(w, np.float32))
    assert params["embed"].dtype == torch.bfloat16
    assert opt.m["embed"].dtype == torch.float32
    assert int(cursor) == int(rcursor)


def test_port_restores_the_reference_checkpoint(tmp_path):
    ref = _state(1)
    RCheckpointer(str(tmp_path)).save(20, ref)
    tcfg = reduce_config(get_config("smollm-360m"))
    params, opt = _port_like(tcfg)
    step, (sp, so, cur) = Checkpointer(str(tmp_path)).restore(
        checkpoint_tree(tcfg, params, opt, 0))
    assert step == 20
    port = (P.unstack_layers(sp),
            AdamState(so.step, P.unstack_layers(so.m), P.unstack_layers(so.v)),
            cur)
    _assert_same(port, ref)


def test_reference_restores_the_port_checkpoint(tmp_path):
    ref = _state(2)
    tcfg = reduce_config(get_config("smollm-360m"))
    params = P.from_numpy_tree(jax.tree.map(np.asarray, ref[0]), device="cpu")
    opt = P.opt_state_from_numpy(jax.tree.map(np.asarray, tuple(ref[1])),
                                 device="cpu")
    Checkpointer(str(tmp_path)).save(30, checkpoint_tree(tcfg, params, opt,
                                                         int(ref[2])))
    like = _state(3)
    step, out = RCheckpointer(str(tmp_path)).restore(like)
    assert step == 30
    assert out[0]["embed"].dtype == jnp.bfloat16
    for g, w in zip(jax.tree.leaves(out), jax.tree.leaves(ref)):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      np.asarray(w, np.float32))


_NO_ML_DTYPES = r"""
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("ml_dtypes", "jax", "jaxlib"):
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, _Block())
import numpy as np, torch
from repro_torch.checkpoint.checkpoint import Checkpointer
ck = Checkpointer(sys.argv[1])
tree = {"w": torch.randn(5, 3).bfloat16(), "f8": torch.randn(4).to(torch.float8_e4m3fn),
        "step": torch.tensor(3, dtype=torch.int32), "cursor": np.int64(9)}
ck.save_async(4, tree)
ck.wait()
step, out = ck.restore(tree)
assert step == 4 and out["w"].dtype == torch.bfloat16
assert torch.equal(out["w"], tree["w"])
assert torch.equal(out["f8"].float(), tree["f8"].float())
assert int(out["cursor"]) == 9
assert not [m for m in sys.modules if m.split(".")[0] in ("ml_dtypes", "jax")]
print("OK")
"""


def test_checkpointer_needs_no_ml_dtypes(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES, str(tmp_path)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "OK" in r.stdout
