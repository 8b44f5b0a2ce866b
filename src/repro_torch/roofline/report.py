"""Roofline report over the dry-run's artifacts: per (arch x shape) of a
mesh, the three terms, the dominant one, model FLOPs over counted FLOPs,
the roofline fraction, the peak per rank and whether it fits an H100's
80 GB.  Port of ``benchmarks/roofline_report.py``, reading the artifacts
``repro_torch.launch.dryrun`` writes under ``build/dryrun``.

  python -m repro_torch.roofline.report --mesh pod16x16 [--csv]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..launch.dryrun import ART_DIR


def rows_for(mesh: str, art_dir: Path = ART_DIR):
    rows = []
    for f in sorted((Path(art_dir) / mesh).glob("*.json")):
        a = json.loads(f.read_text())
        if a.get("status") != "ok":
            rows.append({"arch": a["arch"], "shape": a["shape"],
                         "status": a.get("status", "?")})
            continue
        r = a["roofline"]
        rows.append({
            "arch": a["arch"], "shape": a["shape"], "status": "ok",
            "compute_s": r["compute_s"], "memory_s": r["memory_s"],
            "collective_s": r["collective_s"], "dominant": r["dominant"],
            "useful": r["model_flops_over_counted_flops"],
            "frac": r["roofline_fraction"],
            "peak_gb": a["peak_bytes_per_device"] / 1e9,
            "fits": a["fits_80GB"],
            "mu": a.get("microbatches", 1),
        })
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--dir", default=str(ART_DIR),
                    help="the dry-run's output directory")
    ap.add_argument("--csv", action="store_true")
    args = ap.parse_args(argv)
    rows = rows_for(args.mesh, Path(args.dir))
    if args.csv:
        print("arch,shape,status,compute_s,memory_s,collective_s,dominant,"
              "useful_flops_ratio,roofline_fraction,peak_gb,fits_80GB,mu")
        for r in rows:
            if r["status"] != "ok":
                print(f"{r['arch']},{r['shape']},{r['status']},,,,,,,,,")
                continue
            print(",".join(str(x) for x in (
                r["arch"], r["shape"], "ok", f"{r['compute_s']:.4f}",
                f"{r['memory_s']:.4f}", f"{r['collective_s']:.4f}",
                r["dominant"], f"{r['useful']:.4f}", f"{r['frac']:.5f}",
                f"{r['peak_gb']:.2f}", r["fits"], r["mu"])))
        return rows
    print(f"{'arch':<24}{'shape':<13}{'comp_s':>9}{'mem_s':>9}{'coll_s':>9}"
          f"  {'dominant':<11}{'useful':>7}{'frac':>9}{'peak':>8}{'mu':>4}")
    for r in rows:
        if r["status"] != "ok":
            print(f"{r['arch']:<24}{r['shape']:<13}  -- {r['status']}")
            continue
        print(f"{r['arch']:<24}{r['shape']:<13}{r['compute_s']:>9.3f}"
              f"{r['memory_s']:>9.3f}{r['collective_s']:>9.3f}  "
              f"{r['dominant']:<11}{r['useful']:>7.3f}{r['frac']:>9.5f}"
              f"{r['peak_gb']:>7.1f}G{r['mu']:>4}")
    return rows


if __name__ == "__main__":
    main()
