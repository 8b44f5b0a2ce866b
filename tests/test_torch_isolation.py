"""The port stands alone: no JAX (nor ``ml_dtypes``, which comes with it)
and nothing of ``repro`` in ``repro_torch``, ``tools`` or ``chip_smoke.py``
(the probe runs a workflow through the port's runtime and its static
analysis, too), and entry points and pilots never fall back to the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _port_files():
    return (sorted(PORT.rglob("*.py")) + sorted((REPO / "tools").glob("*.py"))
            + [REPO / "chip_smoke.py"])


def _imported(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "ml_dtypes", "repro")


def test_no_jax_or_reference_imports_in_sources():
    files = _port_files()
    assert len(files) > 10
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imported(f)
           if _forbidden(m)]
    assert bad == []


_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
assert {"repro_torch.roofline.counter", "repro_torch.roofline.analysis",
        "repro_torch.roofline.report", "repro_torch.launch.dryrun",
        "repro_torch.kernels.cost"} <= set(mods), mods
import torch.distributed as dist
assert not dist.is_initialized(), "importing the dry-run made a world"
from repro_torch.launch import serve
out = serve.main(["--reduced", "--requests", "2", "--batch-slots", "2",
                  "--max-new", "3", "--device", "cpu"])
assert len(out) == 2 and all(out.values()), out
import torch
import repro_torch.analysis
from repro_torch.analysis.__main__ import run_static
from repro_torch.core import (DataFlowKernel, PilotDescription, RPEXExecutor,
                              python_app, spmd_app)
rpex = RPEXExecutor(PilotDescription(n_slots=4, devices=[torch.device("cpu")]))

@spmd_app(slots=2)
def double(mesh, x):
    return x * 2.0

@python_app
def total(x):
    return float(x.sum())

with DataFlowKernel(executors={"rpex": rpex}):
    assert total(double(torch.ones(8))).result() == 16.0
rpex.shutdown()
findings, _ = run_static(repro_torch.analysis.__main__.REPO_ROOT)
assert findings, "the static passes read the port's runtime"
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
print("MODULES", len(mods))
print("BAD", bad)
"""


def test_port_runs_without_jax_in_sys_modules():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                       text=True, env=env, cwd=str(REPO), timeout=300)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
    n = int(r.stdout.split("MODULES ")[1].split()[0])
    assert n >= 20


def test_entry_points_refuse_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch import resolve_device
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = reduce_config(get_config("smollm-360m"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--reduced", "--requests", "1"])


def test_pilot_without_devices_refuses_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default devices are usable")
    from repro_torch.core import Pilot, PilotDescription, RPEXExecutor
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Pilot(PilotDescription(n_slots=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RPEXExecutor()
    pilot = Pilot(PilotDescription(n_slots=2, devices=[torch.device("cpu")]))
    try:
        assert pilot.executor.devices == [torch.device("cpu")]
    finally:
        pilot.close()


_SHARD_PROBE = r"""
import sys
import repro_torch.sharding, repro_torch.launch.mesh
import _torch_dist as D
res = D.run_world(D.isolation_probe, 2, sys.argv[1], timeout=120)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
print("RANKS", res)
print("BAD", bad)
"""


def test_sharding_and_a_spawned_worker_load_no_jax(tmp_path):
    """``repro_torch.sharding`` and ``repro_torch.launch.mesh`` import no
    JAX and nothing of ``repro``, nor does a rank that a world spawns and
    that builds a mesh and places a tensor on it (each rank checks its own
    modules, ``tests/_torch_dist.py``)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests")]))
    r = subprocess.run([sys.executable, "-c", _SHARD_PROBE, str(tmp_path)],
                       capture_output=True, text=True, env=env,
                       cwd=str(REPO), timeout=300)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
    assert "RANKS [[], []]" in r.stdout, r.stdout
