"""The harness is driven by data and free of JAX; its check catches the
faults and the control.  On the CPU at a tiny size (``tiny.py``); the
test marked ``gpu`` reads the control on the card at the cells' sizes."""
import json
import re
import shutil
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


def source_copy(tmp_path):
    """A copy of the benchmark's folder and ``BENCHMARK.json`` to add files
    to; returns the folder and the spec."""
    src = tmp_path / "src" / "rpexbench"
    shutil.copytree(HERE, src, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", src.parent)
    return src, json.loads(json.dumps(SPEC))


def write_json(path, data):
    path.write_text(json.dumps(data))


def test_new_files_are_picked_up_without_edits(tmp_path, monkeypatch):
    """A new configuration at its full size with its cut, a new mix with
    its cut and a new metric: files and entries only, and the tiny copy
    runs the configuration at the cut widths."""
    from repro_torch.models import model as M
    src, spec = source_copy(tmp_path)
    cfg = json.loads((HERE / "configs" / "mamba2-1.3b.json").read_text())
    cfg["name"] = cfg["model"]["name"] = "ssm-extra"
    write_json(src / "configs" / "ssm-extra.json", cfg)
    cut = {"num_layers": 1, "d_model": 48, "d_inner": 96,
           "ssm_head_dim": 16, "ssm_state": 8, "ssm_chunk": 8,
           "vocab_size": 131}
    write_json(src / "cuts" / "configs" / "ssm-extra.json", cut)
    mix = json.loads((HERE / "mixes" / "train_workflow.json").read_text())
    mix.update(steps_per_segment=3, eval_every=3)
    write_json(src / "mixes" / "short_train.json", mix)
    write_json(src / "cuts" / "mixes" / "short_train.json",
               {"batch": 2, "seq": 32})
    (src / "metrics" / "steps_done.train.py").write_text(
        "def read(rec):\n    return rec.get('steps')\n")
    spec["configs"].append({"name": "ssm-extra", "source": cfg["source"],
                            "file": "rpexbench/configs/ssm-extra.json",
                            "reduced": [], "why": "a throwaway config"})
    spec["workloads"].append({"name": "ssm-extra.short_train",
                              "config": "ssm-extra",
                              "traffic": "short_train", "chips": 1,
                              "why": "a throwaway cell"})
    spec["end_to_end"].append({"name": "steps_done.train", "unit": "steps",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["ssm-extra.short_train"]})
    write_json(src.parent / "BENCHMARK.json", spec)
    root = tmp_path / "root"
    tiny.make(root, source=src)
    ran = []
    make_train_step = M.make_train_step

    def recording(cfg, *a, **kw):
        step = make_train_step(cfg, *a, **kw)

        def run(params, *b, **kwb):
            ran.append((tuple(params["embed"].shape), len(params["layers"]),
                        tuple(params["layers"][0]["mixer"]["in_proj"].shape)))
            return step(params, *b, **kwb)
        return run
    monkeypatch.setattr(M, "make_train_step", recording)
    # a window long enough to finish a segment on a loaded CPU
    result, _ = run_tiny(root, "ssm-extra.short_train", seconds=2.0)
    assert result["correct"], result
    assert result["metrics"]["steps_done.train"]["value"] % 3 == 0
    assert result["metrics"]["steps_done.train"]["value"] > 0
    # the embedding, the depth and the mixer's projection of the cut
    assert ran and set(ran) == {((131, 48), 1, (48, 2 * 96 + 2 * 8 + 6))}


@pytest.mark.parametrize("kind", ["configs", "mixes"])
def test_a_missing_cut_is_an_error(tmp_path, kind):
    """A configuration or mix with no cut file stops the tiny copy, which
    names the file, before anything runs at full size."""
    src, spec = source_copy(tmp_path)
    name = spec["workloads"][0]["config" if kind == "configs" else "traffic"]
    (src / "cuts" / kind / f"{name}.json").unlink()
    with pytest.raises(FileNotFoundError,
                       match=re.escape(f"cuts/{kind}/{name}.json")):
        tiny.make(tmp_path / "root", source=src)
    assert not (tmp_path / "root").exists()


# the tiny cuts as the benchmark's first cells had them, before they
# became files under cuts/
FIRST_MODEL_CUTS = {
    "mamba2-1.3b": dict(num_layers=2, d_model=64, d_inner=128,
                        ssm_head_dim=32, ssm_state=16, ssm_chunk=8,
                        vocab_size=257),
    "internlm2-1.8b": dict(num_layers=2, d_model=64, num_heads=4,
                           num_kv_heads=2, head_dim=16, d_ff=128,
                           vocab_size=257),
}
FIRST_MIX_CUTS = {
    "train_workflow": dict(batch=2, seq=32, eval_every=2),
    "score_campaign": dict(batch=2, seq=32, check_docs=3),
}
FIRST_LIMITS = {"loss_gap": 0.006, "eval_gap": 0.0032, "grad_gap": 0.012,
                "change_gap": 0.02, "logits_gap": 0.08, "misdelivered": 0}
FIRST_CELLS = ("mamba2-1.3b.train_workflow", "internlm2-1.8b.train_workflow",
               "mamba2-1.3b.score_campaign")


def test_the_first_cells_tiny_files_are_unchanged(tiny_root):
    """The config, mix and limits files of the first three cells, byte for
    byte as the cuts written into ``tiny.py`` made them."""
    pkg = tiny_root / "rpexbench"
    for name, keys in FIRST_MODEL_CUTS.items():
        cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
        cfg["model"].update(keys)
        assert (pkg / "configs" / f"{name}.json").read_text() == \
            json.dumps(cfg)
    for name, keys in FIRST_MIX_CUTS.items():
        mix = json.loads((HERE / "mixes" / f"{name}.json").read_text())
        mix.update(keys)
        assert (pkg / "mixes" / f"{name}.json").read_text() == json.dumps(mix)
    for cell in FIRST_CELLS:
        assert (pkg / "limits" / f"{cell}.json").read_text() == \
            json.dumps(FIRST_LIMITS)


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
    names = sorted(p.stem for p in (HERE / "reference").glob("*.py"))
    code = f"""
import sys, json, importlib
sys.path[:0] = [{str(ROOT)!r}]
for name in {names!r}:
    importlib.import_module("rpexbench.reference." + name)
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


# every fault a cell's workflow can have: a train cell each kind, a score
# cell's prefill half the batch and an altered answer
WORKFLOW_FAULTS = {"train_and_evaluate": faults.KINDS,
                   "prepare_and_score": ("half_batch", "answer")}
FAULTS = [(c["name"], f) for c in SPEC["workloads"] for f in WORKFLOW_FAULTS[
    json.loads((HERE / "mixes" / f"{c['traffic']}.json").read_text())[
        "workflow"]]]


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
