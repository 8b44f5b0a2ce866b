"""``python -m repro_torch.analysis`` — run the static passes, gate on the
committed baseline.

Default scope: the lock-discipline pass over ``src/repro_torch/core``; the
event-protocol and state-machine passes over the port's core and its tests
(``tests/test_torch_*.py``: emitters and consumers both live there).
Exit status is the number of non-baselined findings capped at 1 — CI
fails on any.

    python -m repro_torch.analysis                      # gate against baseline
    python -m repro_torch.analysis --no-baseline        # raw findings
    python -m repro_torch.analysis --list-keys          # keys for baselining
    python -m repro_torch.analysis --graph              # dump the lock graph
    python -m repro_torch.analysis --json out.json      # machine-readable dump
    python -m repro_torch.analysis --check-watchdog-report BENCH_lockorder.json

The last form validates a watchdog JSON report (written by a run with
``REPRO_LOCK_WATCHDOG=1`` + ``REPRO_LOCK_WATCHDOG_OUT=...``): non-zero
on a runtime lock-order cycle, a hold-ceiling breach, or a state-machine
violation.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List

from . import Finding, apply_baseline, load_baseline
from .events import analyze_events, analyze_state_machine
from .locks import analyze_lock_discipline
from .watchdog import DEFAULT_HOLD_CEILING_S, check_snapshot

_HERE = Path(__file__).resolve()
REPO_ROOT = _HERE.parents[3]
DEFAULT_BASELINE = _HERE.parent / "baseline.txt"


def _read_sources(root: Path, rel_dirs, pattern: str = "*.py"
                  ) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for rel in rel_dirs:
        d = root / rel
        if not d.is_dir():
            continue
        for p in sorted(d.glob(pattern)):
            out[str(p.relative_to(root))] = p.read_text()
    return out


def run_static(root: Path):
    """(findings, lock graph) for the repo at ``root``: the port's runtime
    and its tests, not the reference package beside it."""
    lock_sources = _read_sources(root, ["src/repro_torch/core"])
    event_sources = {**lock_sources,
                     **_read_sources(root, ["tests"], "test_torch_*.py")}
    findings: List[Finding] = []
    lk, graph = analyze_lock_discipline(lock_sources)
    findings.extend(lk)
    findings.extend(analyze_events(event_sources))
    findings.extend(analyze_state_machine(event_sources))
    return findings, graph


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--root", default=str(REPO_ROOT),
                    help="repo root (default: autodetected)")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE))
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, baseline ignored")
    ap.add_argument("--list-keys", action="store_true",
                    help="print stable finding keys (baseline format)")
    ap.add_argument("--graph", action="store_true",
                    help="dump the static lock acquisition graph")
    ap.add_argument("--json", metavar="PATH",
                    help="write findings + graph as JSON")
    ap.add_argument("--check-watchdog-report", metavar="PATH",
                    help="validate a runtime watchdog JSON report instead "
                         "of running the static passes")
    ap.add_argument("--hold-ceiling", type=float,
                    default=DEFAULT_HOLD_CEILING_S,
                    help="watchdog held-lock wall-time ceiling, seconds")
    args = ap.parse_args(argv)

    if args.check_watchdog_report:
        snap = json.loads(Path(args.check_watchdog_report).read_text())
        findings = check_snapshot(snap, args.hold_ceiling)
        print(f"watchdog report: {snap.get('locks', 0)} locks, "
              f"{snap.get('edge_count', 0)} order edges, "
              f"{len(snap.get('cycles', []))} cycles, "
              f"max hold {snap.get('max_hold_ms_overall', 0.0):.0f}ms, "
              f"{len(snap.get('transition_violations', []))} "
              f"state-machine violations")
        for f in findings:
            print(f.render())
        print(f"{len(findings)} watchdog finding(s)")
        return 1 if findings else 0

    root = Path(args.root)
    findings, graph = run_static(root)

    if args.graph:
        print("# static lock acquisition graph")
        for lid, info in sorted(graph.locks.items()):
            print(f"  lock {info.display:40s} {info.kind:10s} "
                  f"({lid[0]}:{info.line})")
        for src, dst in sorted(graph.edge_pairs()):
            def disp(l):
                i = graph.locks.get(l)
                return i.display if i else f"{l[0]}.{l[1]}"
            print(f"  edge {disp(src)} -> {disp(dst)}")

    baseline = {} if args.no_baseline else load_baseline(Path(args.baseline))
    new, suppressed, stale = apply_baseline(findings, baseline)

    if args.list_keys:
        for f in sorted(findings, key=lambda f: f.key):
            print(f.key)
        return 0

    if args.json:
        Path(args.json).write_text(json.dumps({
            "findings": [vars(f) for f in findings],
            "new": [vars(f) for f in new],
            "suppressed": suppressed,
            "stale_baseline": stale,
            "graph": {
                "locks": [{"owner": k[0], "attr": k[1],
                           "kind": v.kind, "display": v.display}
                          for k, v in sorted(graph.locks.items())],
                "edges": [{"src": list(s), "dst": list(d)}
                          for s, d in sorted(graph.edge_pairs())],
            }}, indent=2))

    for f in sorted(new, key=lambda f: (f.code, f.path, f.line)):
        print(f.render())
    if stale:
        print(f"# stale baseline entries (fix landed? remove them): "
              f"{', '.join(sorted(stale))}", file=sys.stderr)
    print(f"{len(findings)} finding(s): {len(new)} new, "
          f"{len(suppressed)} baselined, {len(stale)} stale baseline "
          f"entr{'y' if len(stale) == 1 else 'ies'}")
    return 1 if new else 0


if __name__ == "__main__":
    raise SystemExit(main())
