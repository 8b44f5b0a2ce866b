"""How far the train driver's state moves between two ways of running the
same steps: the world against the in-process driver, and the in-process
driver against itself with the batch split into 2 microbatches.

Runs, on the card, smollm-360m's train driver for 4 steps (checkpoints at
steps 2 and 4) at the reduced config (in process and on a 2-rank world,
``--data-shards 2``) and at full width (in process with 1 and with 2
microbatches, and on the world), then prints ``train.state_drift`` of
each pair: for the params, the AdamW moments m and v, the ratio over the
whole tree, the median leaf's and the worst leaf's.  At full width the
reference's init is chaotic (attention scores with a std near 100): a
change of summation order alone moves the state by its own size, which
the microbatch pair measures.

  PYTHONPATH=src python tools/train_state_drift.py     # on the card
"""
import shutil
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def show(train, cfg, what, x, y, steps, names):
    for s in steps:
        d = train.state_drift(cfg, x, y, s, "cuda")
        out = []
        for k in ("params", "m", "v"):
            lv = np.array(d[k]["leaves"])
            fin = lv[np.isfinite(lv)]
            w = d[k]["worst"]
            out.append(f"{k} all {d[k]['all']:.4g} median {np.median(fin):.4g}"
                       f" worst {names[w[1]] if names else w[1]} {w[0]:.4g}")
        print("DRIFT", what, "step", s, d["steps"], "; ".join(out),
              flush=True)


def main():
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.launch import train
    cfg = get_config("smollm-360m")
    names = ["embed", "final_norm"] + [
        f"L{i}.{n}" for i in range(cfg.num_layers)
        for n in ("wg", "wi", "wo_ffn", "wk", "wo", "wq", "wv", "norm1",
                  "norm2")]
    build = ROOT / "build"

    def run(name, argv):
        d = build / f"state_drift_{name}"
        shutil.rmtree(d, ignore_errors=True)
        t = time.time()
        losses = train.main(argv + ["--ckpt-dir", str(d), "--ckpt-every", "2"])
        print("RUN", name, losses, f"{time.time() - t:.1f}s", flush=True)
        return d

    red = ["--reduced", "--steps", "4", "--segment", "2", "--batch", "4",
           "--seq", "64", "--eval-every", "4"]
    r1 = run("reduced_inproc", red)
    r2 = run("reduced_world", red + ["--data-shards", "2"])
    show(train, reduce_config(cfg), "reduced world-vs-inproc", r2, r1,
         (2, 4), None)
    full = ["--arch", "smollm-360m", "--batch", "8", "--seq", "1024",
            "--segment", "2", "--eval-every", "4", "--steps", "4"]
    a = run("full_mb1", full)
    b = run("full_mb2", full + ["--microbatches", "2"])
    c = run("full_world", full + ["--data-shards", "2"])
    show(train, cfg, "full mb2-vs-mb1", b, a, (2, 4), names)
    show(train, cfg, "full world-vs-mb2", c, b, (2, 4), names)
    show(train, cfg, "full world-vs-mb1", c, a, (2,), names)
    for d in (r1, r2, a, b, c):
        shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    main()
