"""The metrics read from the program's own spans and counters
(``repro_torch.trace``): the tiny traced runs report each of them in its
cells, the names of the program's spans keep clear of what the traced
breakdown reads, and a program without the recorder gives no reading."""
import json
import sys
from pathlib import Path

import pytest
import torch

from rpexbench import harness, tiny

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
FROM_SPANS = ("issue_ms.train", "mixer_issue_ms.train", "optimizer_ms.train",
              "handoff_ms.train", "issue_ms.score")
CELLS = [c["name"] for c in SPEC["workloads"]]


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny_spans")
    tiny.make(root)
    return root


def traced(root, cell):
    from repro_torch import trace
    # the check of the outputs is the harness tests' (test_rpexbench_harness)
    result, _ = harness.run_cell(
        cell, 31, 1.5, 1, torch.device("cpu"), 0.0,
        bench=harness.Bench(root / "rpexbench"), log=lambda m: None)
    return result, trace.snapshot()


@pytest.mark.parametrize("cell", CELLS)
def test_traced_runs_report_the_span_metrics(tiny_root, cell):
    result, snap = traced(tiny_root, cell)
    got = {k: v["value"] for k, v in result["metrics"].items()}
    listed = [m["name"] for m in SPEC["per_layer"]
              if m["name"] in FROM_SPANS and cell in m["workloads"]]
    assert listed and all(got.get(k) is not None for k in listed), got
    for s in snap.spans:
        assert not s.name.startswith(("rpx.", "aten::")), s
        assert "cuda" not in s.name, s
    assert snap.dropped == 0
    if cell.endswith("train_workflow"):
        # the remat recompute runs inside the step's backward
        assert 0 < got["mixer_issue_ms.train"] <= got["issue_ms.train"]
        steps = snap.named("train.step")
        assert got["issue_ms.train"] <= max(s.ms for s in steps)
        assert 0 < got["optimizer_ms.train"] < got["step_ms.train"]
        assert got["handoff_ms.train"] > 0
    else:
        assert 0 < got["issue_ms.score"] <= got["infer_task_p95_ms"]


def test_a_program_without_the_recorder_gives_no_reading(monkeypatch):
    bench = harness.Bench()
    rec = {"kind": "train"}
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    for name in FROM_SPANS:
        for kind in ("train", "score"):
            assert bench.reader(name)(dict(rec, kind=kind)) is None
