"""A copy of the benchmark at a size the CPU runs in seconds, for its
tests: the same harness, readers and references under a temporary root,
with each configuration cut to 2 layers of width 64 and each mix to a
few short rows, and limits set for that size."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent

TINY_MODEL = {
    "mamba2-1.3b": dict(num_layers=2, d_model=64, d_inner=128,
                        ssm_head_dim=32, ssm_state=16, ssm_chunk=8,
                        vocab_size=257),
    "internlm2-1.8b": dict(num_layers=2, d_model=64, num_heads=4,
                           num_kv_heads=2, head_dim=16, d_ff=128,
                           vocab_size=257),
}
TINY_MIX = {
    "train_workflow": dict(batch=2, seq=32, eval_every=2),
    "score_campaign": dict(batch=2, seq=32, check_docs=3),
}
# limits at the tiny size on the CPU (the bf16 program against the f32
# reference), set from readings over seeds there: sound runs read at most
# loss 3.4e-3, held-out loss 1.8e-3, worst-leaf gradient 5.3e-3, change
# 1.04e-2, logits 2.2e-2; the fp8 control at least 2.3e-2 (gradient),
# 2.4e-2 (change), 0.187 (logits); the altered answer 4.4e-3 (held-out
# loss) and 1.9 (logits)
TINY_LIMITS = {"loss_gap": 0.006, "eval_gap": 0.0032, "grad_gap": 0.012,
               "change_gap": 0.02, "logits_gap": 0.08, "misdelivered": 0}


def make(root: Path) -> Path:
    """A tiny copy of the benchmark under ``root``; returns the copy's
    package directory."""
    pkg = root / "rpexbench"
    shutil.copytree(HERE, pkg, ignore=shutil.ignore_patterns(
        "__pycache__", "test_*"))
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for name, cut in TINY_MODEL.items():
        path = pkg / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["model"].update(cut)
        path.write_text(json.dumps(cfg))
    for name, cut in TINY_MIX.items():
        path = pkg / "mixes" / f"{name}.json"
        mix = json.loads(path.read_text())
        mix.update(cut)
        path.write_text(json.dumps(mix))
    (pkg / "limits").mkdir(exist_ok=True)
    for cell in spec["workloads"]:
        (pkg / "limits" / f"{cell['name']}.json").write_text(
            json.dumps(TINY_LIMITS))
    return pkg
