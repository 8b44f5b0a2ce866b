#!/usr/bin/env python3
"""Two source trees' full-width step times, in turns on one card.

Times on one CUDA card, for each source tree given, steps of the port as
``chip_smoke.py`` runs them: the smollm-360m train step (bf16, B=8,
S=1024, all 32 layers, remat "full", AdamW; ``phase_train_timings``), the
qwen3-moe-235b-a22b prefill step (bf16, B=8, S=1024, full width cut to 4
of its 94 layers; ``phase_moe``), and with ``--steps`` also mamba2-1.3b's
train and prefill steps (bf16, B=8, S=1024, all 48 layers).  Each tree runs in a worker
process of its own with that tree's ``src`` first on the path, so two
versions of the package run side by side on the card, one at a time.
The trees take turns, A B B A for each pair, and each reading is the mean
of ``--iters`` steps by CUDA events after ``--warmup`` steps.  Weights are
random from chip_smoke.py's seeds.  Prints JSON lines: each reading, then
per step and tree the median, min and max of its readings.

Usage (needs a CUDA card; from the repo root, the tree to compare with
unpacked under build/, which .gitignore lists):
  mkdir -p build/parent && git archive HEAD^ | tar -x -C build/parent
  python tools/step_pairs.py build/parent . --pairs 5
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

STEPS = ("smollm-train", "qwen3-moe-prefill")   # the default
MORE_STEPS = ("mamba2-train", "mamba2-prefill")
B, S = 8, 1024
QWEN_LAYERS = 4


# -------------------------------- worker -------------------------------- #

def _cuda_ms(fn, iters, warmup):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _train(arch):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamW, cosine_schedule
    cfg = get_config(arch)
    params = T.init_params(cfg, 0, device="cuda")
    opt = AdamW(lr=cosine_schedule(3e-4, 20, 10_000))
    holder = [params, opt.init(params)]
    step = M.make_train_step(cfg, opt)
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).cuda(),
             "targets": torch.from_numpy(toks[:, 1:]).cuda(),
             "loss_mask": torch.ones((B, S), device="cuda")}

    def run():
        holder[0], holder[1], _ = step(holder[0], holder[1], batch)
    return run


def _qwen_prefill():
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"),
                              num_layers=QWEN_LAYERS)
    params = T.init_params(cfg, 21, device="cuda")
    for layer in params["layers"]:      # chip_smoke.py's smoke_params
        for name in ("wq", "wk", "wv"):
            w = layer["mixer"][name]
            w.mul_((w.shape[-2] / w.shape[0]) ** 0.5)
    toks = np.random.default_rng(22).integers(0, cfg.vocab_size, (B, S))
    batch = {"tokens": torch.from_numpy(toks).cuda()}
    step = M.make_prefill_step(cfg)
    return lambda: step(params, batch)


def _mamba_prefill():
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    cfg = get_config("mamba2-1.3b")
    params = T.init_params(cfg, 0, device="cuda")
    toks = np.random.default_rng(23).integers(0, cfg.vocab_size, (B, S))
    batch = {"tokens": torch.from_numpy(toks).cuda()}
    step = M.make_prefill_step(cfg)
    return lambda: step(params, batch)


def worker(iters, warmup):
    """Reads a step's name a line, answers its time in ms a line; an
    empty line frees the step held."""
    import gc
    import torch
    made = {"smollm-train": lambda: _train("smollm-360m"),
            "qwen3-moe-prefill": _qwen_prefill,
            "mamba2-train": lambda: _train("mamba2-1.3b"),
            "mamba2-prefill": _mamba_prefill}
    held = {}
    for line in sys.stdin:
        name = line.strip()
        if not name:
            held.clear()
            gc.collect()
            torch.cuda.empty_cache()
            print(json.dumps({"freed": True}), flush=True)
            continue
        if name not in held:
            held[name] = made[name]()
            _cuda_ms(held[name], 1, warmup)
        print(json.dumps({"ms": _cuda_ms(held[name], iters, 0)}), flush=True)


# ------------------------------ coordinator ----------------------------- #

class _Tree:
    def __init__(self, path, args):
        src = str(Path(path).resolve() / "src")
        env = dict(os.environ, PYTHONPATH=src)
        self.path = path
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             "--iters", str(args.iters), "--warmup", str(args.warmup)],
            cwd=path, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True)

    def ask(self, name):
        self.proc.stdin.write(name + "\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the worker of {self.path} ended "
                               f"(exit {self.proc.wait()})")
        return json.loads(line)

    def close(self):
        self.proc.stdin.close()
        self.proc.wait(timeout=60)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", help="two source trees, A then B")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", default=",".join(STEPS),
                    help="of " + ", ".join(STEPS + MORE_STEPS))
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.iters, args.warmup)
    if len(args.trees) != 2:
        ap.error("give two source trees")
    trees = [_Tree(p, args) for p in args.trees]
    try:
        for name in args.steps.split(","):
            got = {t.path: [] for t in trees}
            for i in range(args.pairs):
                for t in (trees[0], trees[1], trees[1], trees[0]):
                    ms = t.ask(name)["ms"]
                    got[t.path].append(ms)
                    print(json.dumps({"step": name, "pair": i,
                                      "tree": t.path, "ms": ms}), flush=True)
            for path, ms in got.items():
                print(json.dumps({
                    "step": name, "tree": path, "n": len(ms),
                    "median_ms": statistics.median(ms), "min_ms": min(ms),
                    "max_ms": max(ms)}), flush=True)
            for t in trees:
                t.ask("")
    finally:
        for t in trees:
            t.close()


if __name__ == "__main__":
    main()
