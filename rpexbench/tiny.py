"""A copy of the benchmark at a size the CPU runs in seconds, for its
tests: the same harness, readers and references under a temporary root,
with each configuration and mix that a cell names cut by its file under
``cuts/``, found by name like everything else:

- ``cuts/configs/<config>.json``: the ``model`` keys that replace the
  full-size ones;
- ``cuts/mixes/<mix>.json``: the mix keys that replace them;
- ``cuts/limits/<cell>.json`` (optional): the cell's limits at that size,
  in place of ``TINY_LIMITS``.

A configuration or mix with no cut file is an error: the CPU never runs
the full size.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent

# limits at the tiny size on the CPU (the bf16 program against the f32
# reference), set from readings over seeds there: sound runs read at most
# loss 3.4e-3, held-out loss 1.8e-3, worst-leaf gradient 5.3e-3, change
# 1.04e-2, logits 2.2e-2; the fp8 control at least 2.3e-2 (gradient),
# 2.4e-2 (change), 0.187 (logits); the altered answer 4.4e-3 (held-out
# loss) and 1.9 (logits)
TINY_LIMITS = {"loss_gap": 0.006, "eval_gap": 0.0032, "grad_gap": 0.012,
               "change_gap": 0.02, "logits_gap": 0.08, "misdelivered": 0}

# a cell's key naming each kind of file that has a cut
CUT_KINDS = (("configs", "config"), ("mixes", "traffic"))


def cut(kind: str, name: str, source: Path = HERE) -> dict:
    """The keys that the tiny copy puts in place of the full-size ones of
    the configuration or mix ``name`` (``kind`` "configs" or "mixes")."""
    path = source / "cuts" / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(
            f"no tiny cut for {name!r}: {path} is missing (the CPU tests "
            f"never run a configuration or mix at its full size)")
    return json.loads(path.read_text())


def limits(cell: str, source: Path = HERE) -> dict:
    """The cell's limits at the tiny size: its file under ``cuts/limits``,
    or ``TINY_LIMITS``."""
    path = source / "cuts" / "limits" / f"{cell}.json"
    return json.loads(path.read_text()) if path.is_file() else TINY_LIMITS


def make(root: Path, source: Path = HERE) -> Path:
    """A tiny copy under ``root`` of the benchmark whose folder is
    ``source`` (``BENCHMARK.json`` beside it); returns the copy's package
    directory."""
    spec = json.loads((source.parent / "BENCHMARK.json").read_text())
    named = {(kind, c[key]) for kind, key in CUT_KINDS
             for c in spec["workloads"]}
    cuts = {k: cut(*k, source) for k in sorted(named)}
    pkg = root / "rpexbench"
    shutil.copytree(source, pkg, ignore=shutil.ignore_patterns(
        "__pycache__", "test_*"))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for (kind, name), keys in cuts.items():
        path = pkg / kind / f"{name}.json"
        data = json.loads(path.read_text())
        (data["model"] if kind == "configs" else data).update(keys)
        path.write_text(json.dumps(data))
    (pkg / "limits").mkdir(exist_ok=True)
    for cell in spec["workloads"]:
        (pkg / "limits" / f"{cell['name']}.json").write_text(
            json.dumps(limits(cell["name"], source)))
    return pkg
