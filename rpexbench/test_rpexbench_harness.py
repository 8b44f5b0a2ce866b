"""The harness is driven by data and free of JAX; its check catches the
faults and the control.  On the CPU at a tiny size (``tiny.py``); the
test marked ``gpu`` reads the control on the card at the cells' sizes."""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from rpexbench import faults, harness, tiny
from rpexbench.workflows import KINDS, Workflow

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in SPEC["workloads"]]
TRAIN = [c for c in CELLS if c.endswith("train_workflow")]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def run_tiny(root, cell, seed=21, **kw):
    bench = harness.Bench(root / "rpexbench")
    return harness.run_cell(cell, seed, kw.pop("seconds", 0.5),
                            kw.pop("trace", 0), torch.device("cpu"), 0.0,
                            bench=bench, log=lambda m: None, **kw)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    tiny.make(root)
    return root


def test_every_cell_finds_its_files():
    bench = harness.Bench()
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for c in SPEC["configs"]:
        assert c["file"] == f"rpexbench/configs/{c['name']}.json"
        cfg = bench.config(c["name"])
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert bench.reference(cfg["reference"]).leaves(cfg["model"])
    for cell in SPEC["workloads"]:
        assert NAME.match(cell["name"]) and cell["chips"] == 1
        assert bench.mix(cell["traffic"])["workflow"] in KINDS
        assert bench.limits(cell["name"]), cell["name"]
        reported = set()
        for group in ("end_to_end", "per_layer"):
            for name, unit, read in bench.metrics(cell["name"], group):
                assert callable(read) and NAME.match(name)
                assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", unit)
                reported.add(name)
        assert "setup_s" in reported and len(reported & e2e) >= 2
        for m in SPEC["per_layer"]:
            if cell["name"] in m.get("workloads", [cell["name"]]):
                assert m["moves"] in reported
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_new_files_are_picked_up_without_edits(tmp_path):
    """A new configuration, mix and metric: files and entries only."""
    tiny.make(tmp_path)
    pkg = tmp_path / "rpexbench"
    cfg = json.loads((pkg / "configs" / "mamba2-1.3b.json").read_text())
    cfg["name"] = cfg["model"]["name"] = "mamba2-extra"
    (pkg / "configs" / "mamba2-extra.json").write_text(json.dumps(cfg))
    mix = json.loads((pkg / "mixes" / "train_workflow.json").read_text())
    mix.update(steps_per_segment=3, eval_every=3)
    (pkg / "mixes" / "short_train.json").write_text(json.dumps(mix))
    (pkg / "metrics" / "steps_done.train.py").write_text(
        "def read(rec):\n    return rec.get('steps')\n")
    (pkg / "limits" / "mamba2-extra.short_train.json").write_text(
        json.dumps(tiny.TINY_LIMITS))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "mamba2-extra.short_train",
                              "config": "mamba2-extra",
                              "traffic": "short_train", "chips": 1,
                              "why": "a throwaway cell"})
    spec["end_to_end"].append({"name": "steps_done.train", "unit": "steps",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["mamba2-extra.short_train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    # a window long enough to finish a segment on a loaded CPU
    result, _ = run_tiny(tmp_path, "mamba2-extra.short_train",
                         seconds=2.0)
    assert result["correct"], result
    assert result["metrics"]["steps_done.train"]["value"] % 3 == 0
    assert result["metrics"]["steps_done.train"]["value"] > 0


def test_overheads_leave_out_waits_for_slots():
    """A task queued behind another's slots counts its overhead from that
    task's DONE; one that never waited, from its first event."""
    wf = Workflow.__new__(Workflow)
    wf.events = [{"uid": u, "event": "STATE", "state": st, "t": t}
                 for u, st, t in (("a", "TRANSLATED", 0.0),
                                  ("a", "SCHEDULED", 0.001),
                                  ("b", "TRANSLATED", 0.002),
                                  ("a", "DONE", 0.2),
                                  ("b", "SCHEDULED", 0.203),
                                  ("b", "DONE", 0.4))]
    assert wf.overheads([("a", 0.195), ("b", 0.19)]) == \
        pytest.approx([0.005, 0.01])


def test_a_dry_pass_loads_no_jax(tmp_path):
    """No module of a CPU run of the harness, the program and the reference
    has the top-level name jax, jaxlib, flax or repro (nor benchmarks,
    tools or chip_smoke)."""
    code = f"""
import sys, json, torch
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from pathlib import Path
from rpexbench import harness, tiny
root = Path({str(tmp_path)!r})
tiny.make(root)
for cell in {CELLS!r}:
    harness.run_cell(cell, 5, 0.3, 1, torch.device("cpu"), 0.0,
                     bench=harness.Bench(root / "rpexbench"),
                     log=lambda m: None)
print(json.dumps(harness.forbidden_modules(harness.NOT_IMPORTED)))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_references_import_nothing_of_the_program():
    code = f"""
import sys, json
sys.path[:0] = [{str(ROOT)!r}]
import rpexbench.reference.common, rpexbench.reference.mamba2
import rpexbench.reference.transformer
print(json.dumps(sorted(m for m in sys.modules
                        if m.split('.')[0] in ('repro_torch', 'repro', 'jax'))))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_run_without_a_card_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(tiny_root, cell):
    result, checks = run_tiny(tiny_root, cell, trace=1)
    assert result["correct"], checks
    assert list(result)[-1] == "checks"
    assert result["device"]["window_s"] > 0


FAULTS = [(c, f) for c in TRAIN for f in faults.KINDS] + [
    ("mamba2-1.3b.score_campaign", "half_batch"),
    ("mamba2-1.3b.score_campaign", "answer")]


@pytest.mark.parametrize("cell, fault", FAULTS)
def test_faults_come_out_incorrect(tiny_root, cell, fault):
    with faults.planted(fault):
        result, checks = run_tiny(tiny_root, cell, seed=22)
    assert not result["correct"], checks


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_check(tiny_root, cell):
    extra = {}
    result, checks = run_tiny(tiny_root, cell, seed=22, extra=extra,
                              control=True)
    assert result["correct"], checks
    limits = harness.Bench(tiny_root / "rpexbench").limits(cell)
    assert any(extra["control"][k] > lim for k, lim in limits.items()
               if k in extra["control"]), extra["control"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_on_the_card(cell):
    """The control at the cell's own size on the card: the program's run
    within every limit, the control beyond one of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    extra = {}
    result, checks = harness.run_cell(cell, 7, 3.0, 0,
                                      torch.device("cuda", 0), 0.0,
                                      extra=extra, control=True)
    assert result["correct"], checks
    limits = harness.Bench().limits(cell)
    assert any(extra["control"][k] > lim for k, lim in limits.items()
               if k in extra["control"]), extra["control"]
