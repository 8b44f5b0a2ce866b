"""The readings a cell's limits are set from, on the chip at the cell's
own size (not run by the benchmark's runs).

    python3 rpexbench/readings.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--faults half_batch,answer] \\
        [--seconds 3] [--out chiprun_out/readings.jsonl]

For each seed, in one process: a run of the cell with a short window
(``--seconds``, long enough for the check to find its documents) and its
check against the reference, the program sound; on ``--control-seeds``
also the control's numbers (the reference in fp8 in the program's place,
against the same reference); and for each of ``--faults`` a run with that
fault planted (``faults.py``).  One JSON line per reading.
"""
import time

T_PROC = time.monotonic()

import argparse     # noqa: E402
import json         # noqa: E402
import sys          # noqa: E402
from pathlib import Path   # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def ints(text):
    return [int(x) for x in text.split(",") if x]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=ints, required=True)
    ap.add_argument("--control-seeds", type=ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from rpexbench import faults
    from rpexbench.harness import run_cell
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else \
        torch.device("cpu")
    out = open(args.out, "a") if args.out else None
    kinds = [None] + [f for f in args.faults.split(",") if f]
    for seed in args.seeds:
        for kind in kinds:
            control = kind is None and seed in args.control_seeds
            t = time.monotonic()
            extra = {}
            with faults.planted(kind):
                res, _ = run_cell(args.workload, seed, args.seconds, 0, dev,
                                  time.monotonic(), extra=extra,
                                  control=control)
            line = {"workload": args.workload, "seed": seed,
                    "fault": kind, "correct": res["correct"],
                    "numbers": extra["numbers"],
                    "control": extra.get("control"),
                    "seconds": time.monotonic() - t,
                    "peak": res["device"]["memory_peak_bytes"],
                    "metrics": res["metrics"]}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
    print(json.dumps({"device": res["device"], "total_s":
                      time.monotonic() - T_PROC}), flush=True)


if __name__ == "__main__":
    main()
