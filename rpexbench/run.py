"""Run one cell of the port's benchmark once and print its result.

    python3 rpexbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this folder and
``src/repro_torch``, on a machine with the CUDA cards the cell asks for.
The last line of standard output is the result (JSON); the last lines of
standard error are the numbers of the check, each beside its limit.  The
kernels build into ``build/repro_torch_kernels`` inside the checkout on
the first run there.
"""
import time

T_PROC = time.monotonic()

import argparse     # noqa: E402
import json         # noqa: E402
import os           # noqa: E402
import sys          # noqa: E402
from pathlib import Path   # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in spec["workloads"]}
    if args.workload not in cells:
        sys.exit(f"unknown workload {args.workload!r}; known: {sorted(cells)}")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(ROOT / "build" / "rpexbench_cache" / sub)
    import torch
    need = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        sys.exit(f"rpexbench needs {need} CUDA device(s); "
                 f"available: {torch.cuda.device_count()}")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from rpexbench.harness import run_cell
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              args.trace, torch.device("cuda", 0), T_PROC)
    for k, (v, lim) in checks.items():
        print(f"[check] {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
