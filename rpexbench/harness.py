"""One run of one cell: set-up, the measured window, the metrics and the
check, found by the names in ``BENCHMARK.json``.

A cell names a configuration (``configs/<config>.json``: the model's
sizes as run, its source and cuts, and the family whose plain reference
is ``reference/<reference>.py``) and a traffic mix (``mixes/<traffic>.json``,
whose ``workflow`` key picks the generator in ``workflows.KINDS``); its
limits are ``limits/<cell>.json`` and each metric's reader is
``metrics/<metric>.py``, a ``read(rec)`` that returns a number or None.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
NOT_IMPORTED = FORBIDDEN + ("benchmarks", "tools", "chip_smoke")


class Bench:
    """``BENCHMARK.json`` beside the folder that holds this file, and the
    files its names lead to."""

    def __init__(self, here: Path = HERE):
        self.here = here
        self.spec = json.loads((here.parent / "BENCHMARK.json").read_text())
        self.cells = {c["name"]: c for c in self.spec["workloads"]}

    def json(self, kind, name):
        return json.loads((self.here / kind / f"{name}.json").read_text())

    def config(self, name):
        return self.json("configs", name)

    def mix(self, name):
        return self.json("mixes", name)

    def limits(self, cell):
        path = self.here / "limits" / f"{cell}.json"
        return json.loads(path.read_text()) if path.exists() else {}

    def reference(self, name):
        return importlib.import_module(f"{__package__}.reference.{name}")

    def metrics(self, cell, group):
        """(name, unit, reader) of each metric of ``group`` the cell
        reports: those that list it, and those that list no cell."""
        out = []
        for m in self.spec[group]:
            if cell in m.get("workloads", [cell]):
                out.append((m["name"], m["unit"], self.reader(m["name"])))
        return out

    def reader(self, name):
        path = self.here / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"{__package__}.metrics.{name.replace('.', '__')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def forbidden_modules(names=FORBIDDEN):
    """Top-level names of loaded modules that the port's benchmark may not
    load: JAX and the JAX package (whole names: ``repro_torch`` is not
    ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(names))


def device_info(device, peak):
    import torch
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}


def run_cell(name, seed, seconds, trace, device, t_proc, bench=None,
             log=None, extra=None, control=False):
    """Run the cell once; returns the result line (a dict) and the checks
    (name -> (value, limit)).  ``extra``, a dict, receives every number of
    the check (``numbers``) and, with ``control``, the same numbers of the
    control, the reference computed in fp8 in the program's place
    (``control``); the benchmark's own runs compute no control."""
    import torch
    from . import workflows
    from .tracing import Tracer
    bench = bench or Bench()
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = bench.cells[name]
    cfg, mix = bench.config(cell["config"]), bench.mix(cell["traffic"])
    limits = bench.limits(name)
    tracer = Tracer(bool(trace), device)
    wf = workflows.KINDS[mix["workflow"]](
        cfg, mix, bench.reference(cfg["reference"]), seed, device, tracer)
    if device.type == "cuda":
        from repro_torch.kernels import _build
        _build.build()
        torch.cuda.init()
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    try:
        wf.setup()
        setup_s = time.monotonic() - t_proc
        log(f"[rpexbench] {name} seed {seed}: set-up {setup_s:.3f} s")
        rec = wf.window(seconds)
    finally:
        wf.stop_runtime()
    wf.after(rec)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    rec.update(setup_s=setup_s, seconds=seconds, model=cfg["model"],
               mix=mix, trace=tracer.summary)
    log(f"[rpexbench] window: {json.dumps(summary(rec))}")
    found = forbidden_modules()
    if found:
        raise SystemExit(f"[rpexbench] loaded modules the port's benchmark "
                         f"may not load: {found}")
    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for mname, unit, read in bench.metrics(name, group):
        v = read(rec)
        if v is not None:
            metrics[mname] = {"value": v, "unit": unit}
    checks, sound = judge(wf, rec, limits, log, extra, control)
    correct = sound and all(v <= lim for v, lim in checks.values())
    result = {"correct": correct, "attempted": wf.attempted,
              "failed": wf.failed, "metrics": metrics,
              "device": device_info(device, peak)}
    if trace and tracer.summary is not None:
        s = tracer.summary
        result["device"].update(busy_s=s["busy_s"], window_s=s["window_s"])
        result["breakdown"] = {"device_ops": s["device_ops"],
                               "idle_gaps": s["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks


def summary(rec):
    out = {k: rec[k] for k in ("tokens", "span_s", "steps", "setup_s")
           if k in rec}
    if rec.get("trace"):
        out.update({k: rec["trace"][k] for k in ("launches", "reduce_s")})
    return out


def judge(wf, rec, limits, log, extra=None, control=False):
    """Free the program's state, run the reference and compare: (name ->
    (value, limit), whether the window itself was sound).  A number with
    no limit fails."""
    from .reference.common import Precision
    sound = wf.failed == 0
    t = time.monotonic()
    if rec["kind"] == "train":
        prog, kw = wf.prog, {}
        sound = sound and wf.window_sound()
    else:
        docs = wf.sample(rec["counted_docs"])
        prog, kw = {d: wf.results[d]["logits"] for d in docs}, {"docs": docs}
        sound = sound and bool(docs)
    wf.free()
    ref = wf.judge(**kw)
    numbers = wf.compare(prog, ref)
    if rec["kind"] == "score":
        numbers["misdelivered"] = rec["misdelivered"]
    if extra is not None:
        extra["numbers"] = dict(numbers)
        if control:
            extra["control"] = wf.compare(wf.judge(Precision("fp8"), **kw),
                                          ref)
    log(f"[rpexbench] reference: {time.monotonic() - t:.3f} s")
    for k, v in numbers.items():
        if k not in limits:
            log(f"[reading] {k} {v!r} (not compared)")
    if not limits:
        log("[rpexbench] no limits for this cell: nothing is compared")
        sound = False
    return {k: (v, limits[k]) for k, v in numbers.items() if k in limits}, \
        sound
