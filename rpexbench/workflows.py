"""The benchmark's one traffic generator: RPEX workflows written as a
user writes them, against the port's public API, and driven by a mix's
parameters (``mixes/<traffic>.json``, whose ``workflow`` key picks one of
``KINDS``).

``train_and_evaluate`` (the Colmena pattern): chained ``train_segment``
spmd tasks of ``steps_per_segment`` AdamW steps each on
``segment_slots`` slots, each taking the previous segment's future, so
the runtime starts each segment; every ``eval_every`` segments the
segment ends with a device-side snapshot of the weights and an
``evaluate`` python task takes the loss of a held-out batch on it.  The
training state and the snapshots stay on the pilot's device, held by the
workflow as a model resident on the pilot; the futures carry each task's
readings.  (Carried in the futures, the state is published to the
runtime's object store, which spills each segment's 13.5 GB to disk once
its consumers have completed.)

``prepare_and_score`` (the Ice Wedge Polygons pattern): a closed loop of
``in_flight`` documents; each is a ``prepare`` python task (the token ids
of one document, drawn from the seed and its index, standing in for
tiling or tokenisation on a CPU slot) feeding a ``score`` spmd task on
``score_slots`` slots that runs the prefill step and returns the
last-token logits to the host; a new document is submitted as each one
completes.  A score that takes more than half of the pilot's slots runs
alone, so its prefill is dispatched from one thread while the next
document is prepared beside it.

Each workflow's ``setup`` draws the weights, starts the pilot and runs
its warm-up through the same calls the window makes; ``window`` runs for
the given seconds and returns the record the metric readers take;
``judge`` compares what the timed path produced with the family's plain
reference (``reference/<family>.py``) and returns the numbers compared.
"""
from __future__ import annotations

import bisect
import queue
import time

import numpy as np
import torch

from . import weights as W
from .reference import common as R

# streams of one seed's token draws
TRAIN, HELD_OUT, DOCS, WARM_DOC = 1, 2, 3, 4


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """Device time of the work between ``start`` and ``stop``: CUDA
    events on the card, the host clock on the CPU; read ``ms`` after a
    synchronize."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def start(self):
        if self.cuda:
            self.a.record()
        else:
            self.t = time.perf_counter()
        return self

    def stop(self):
        if self.cuda:
            self.b.record()
        else:
            self.t = (time.perf_counter() - self.t) * 1e3

    def ms(self):
        return self.a.elapsed_time(self.b) if self.cuda else self.t


def by_path(tree, path):
    node = tree
    for key in path.split("."):
        node = node[int(key)] if isinstance(node, list) else node[key]
    return node


class Workflow:
    def __init__(self, cfg: dict, mix: dict, ref, seed: int, device,
                 tracer):
        from repro_torch.configs.base import ModelConfig
        self.cfgj, self.mix, self.ref = cfg, mix, ref
        self.m = cfg["model"]
        self.cfg = ModelConfig(**self.m)
        self.seed, self.device, self.tracer = seed, device, tracer
        self.dtype = getattr(torch, self.m["dtype"])
        self.leaves = ref.leaves(self.m)
        self.failed, self.attempted = 0, 0

    # --------------------------- the runtime --------------------------- #
    def start_runtime(self):
        from repro_torch.core import (DataFlowKernel, PilotDescription,
                                      RPEXExecutor)
        self.rpex = RPEXExecutor(PilotDescription(
            n_slots=self.mix["slots"], devices=[self.device]))
        self.dfk = DataFlowKernel(executors={"rpex": self.rpex})
        self.dfk.__enter__()

    def stop_runtime(self):
        if getattr(self, "dfk", None) is None:
            return
        self.events = self.rpex.pilot.store.events_snapshot()
        try:
            self.dfk.__exit__(None, None, None)
        finally:
            self.rpex.shutdown()
            self.dfk = None

    def overheads(self, tasks):
        """Seconds of each (task uid, body seconds): its first journal
        event to DONE, less its body's own seconds and less its wait for
        slots that other tasks held, which ends at the last DONE of
        another task before its SCHEDULED."""
        first, sched, done = {}, {}, {}
        for e in self.events:
            uid = e.get("uid")
            if uid is None:
                continue
            first.setdefault(uid, e["t"])
            if e.get("state") == "SCHEDULED":
                sched[uid] = e["t"]
            elif e.get("state") == "DONE":
                done[uid] = e["t"]
        releases = sorted(done.values())
        out = []
        for u, body in tasks:
            if u not in done:
                continue
            start = first[u]
            i = bisect.bisect_left(releases, sched.get(u, start))
            if i:
                start = max(start, releases[i - 1])
            out.append(done[u] - start - body)
        return out

    def to_device(self, toks):
        """A batch as the train driver feeds it: token ids and next-token
        targets (int32) and a full loss mask, copied from the host."""
        with self.tracer.span("rpx.to_device"):
            t = torch.from_numpy(toks.astype(np.int32))
            return {"tokens": t[:, :-1].to(self.device),
                    "targets": t[:, 1:].to(self.device),
                    "loss_mask": torch.ones(t[:, 1:].shape,
                                            device=self.device)}

    def free(self):
        """Drop the program's state and give its memory back."""
        for k in ("w", "p0", "state", "snaps", "last", "docs", "warm"):
            self.__dict__.pop(k, None)
        import gc
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def ref_params(self):
        """The reference's copy of the drawn weights: float32 tensors of
        the same values, and each leaf's stored type."""
        w = W.draw(self.leaves, self.seed, self.device, self.dtype)
        stores = w.stores()
        params = {p: v.float() for p, v in w.views.items()}
        del w
        return params, stores


class TrainAndEvaluate(Workflow):
    def batch(self, stream, i):
        mx = self.mix
        return W.tokens(self.seed, stream, i, (mx["batch"], mx["seq"] + 1),
                        self.m["vocab_size"])

    def optimizer(self):
        from repro_torch.optim import AdamW, cosine_schedule
        o = self.mix["optimizer"]
        return AdamW(lr=cosine_schedule(o["lr"], o["warmup"], o["total"]),
                     b1=o["b1"], b2=o["b2"], eps=o["eps"],
                     weight_decay=o["weight_decay"],
                     clip_norm=o["clip_norm"])

    def setup(self):
        from repro_torch.core import python_app, spmd_app
        from repro_torch.models import model as M
        mx = self.mix
        self.w = W.draw(self.leaves, self.seed, self.device, self.dtype)
        self.p0 = self.w.clone()
        self.paths = [p for p, _, _ in self.leaves]
        params = self.w.tree()
        opt = self.optimizer()
        step_fn = M.make_train_step(self.cfg, opt)
        tracer, n = self.tracer, mx["steps_per_segment"]

        def train_segment(mesh, prev, first, tokens, snapshot, probe):
            # the training state stays on the pilot's device, in
            # ``self.state``; the futures carry only this segment's
            # readings, so the chain orders the segments without the data
            # plane publishing the state
            t0 = time.perf_counter()
            params, opt_state = self.state
            losses, timers = [], []
            with tracer.span("rpx.segment"):
                for i, toks in enumerate(tokens):
                    with tracer.span("rpx.step"):
                        batch = self.to_device(toks)
                        timers.append(Timer(self.device).start())
                        params, opt_state, met = step_fn(params, opt_state,
                                                         batch)
                        timers[-1].stop()
                    losses.append(met["loss"])
                    if probe is not None:
                        probe(first + i + 1, params, opt_state)
                self.state = (params, opt_state)
                if snapshot:
                    self.snaps[first + len(tokens)] = self.w.clone()
                sync(self.device)
            body = time.perf_counter() - t0
            return {"losses": [float(x) for x in losses],
                    "step_ms": [t.ms() for t in timers], "body_s": body,
                    "first": first, "n": len(tokens),
                    "snap": first + len(tokens) if snapshot else None}

        def evaluate(seg, toks):
            t0 = time.perf_counter()
            snap = self.snaps.pop(seg["snap"])
            with tracer.span("rpx.evaluate"), torch.no_grad():
                loss, _ = M.loss_fn(self.cfg, snap.tree(),
                                    self.to_device(toks))
                loss = float(loss)
            del snap
            return {"loss": loss, "step": seg["snap"],
                    "body_s": time.perf_counter() - t0}

        self.segment = spmd_app(slots=mx["segment_slots"],
                                jit=False)(train_segment)
        self.evaluate = python_app(evaluate)
        self.start_runtime()
        # warm-up through the window's own calls: segments until step 3 is
        # done (two at least), an evaluation after the first; the probes
        # keep what the check compares (the first gradient, the change
        # after step 3)
        self.prog, self.snaps = {}, {}
        self.state = (params, opt.init(params))
        segs, last, losses = max(2, -(-3 // n)), None, []
        for k in range(segs):
            last = self.segment(last, k * n, [self.batch(TRAIN, k * n + i)
                                              for i in range(n)],
                                k == 0, self.probe)
            if k == 0:
                fe = self.evaluate(last, self.batch(HELD_OUT, 0))
            losses += last.result()["losses"]
        self.prog["losses"] = losses[:3]
        self.prog["eval_loss"] = fe.result()["loss"]
        self.last, self.next = last, segs * n
        sync(self.device)

    def probe(self, step, params, opt_state):
        b1 = self.mix["optimizer"]["b1"]
        if step == 1:
            self.prog["grad_norms"] = [
                x / (1 - b1) for x in R.norms(
                    {p: by_path(opt_state.m, p) for p in self.paths},
                    self.paths)]
        if step == 3:
            self.prog["change_norms"] = R.norms(
                {p: by_path(params, p).float() - self.p0.views[p].float()
                 for p in self.paths}, self.paths)
            self.p0 = None

    def window(self, seconds):
        mx = self.mix
        n, every = mx["steps_per_segment"], mx["eval_every"]
        done_t, segs, evals = {}, [], []

        def submit():
            k = len(segs)
            snap = (k + 1) % every == 0
            toks = [self.batch(TRAIN, self.next + i) for i in range(n)]
            f = self.segment(self.last, self.next, toks, snap, None)
            f.add_done_callback(lambda f: done_t.setdefault(
                id(f), time.monotonic()))
            segs.append(f)
            if snap:
                evals.append(self.evaluate(f, self.batch(HELD_OUT, k + 1)))
            self.last, self.next = f, self.next + n

        self.tracer.start()
        t0 = time.monotonic()
        for _ in range(mx["lookahead"]):
            submit()
        i = 0
        while i < len(segs):
            try:
                segs[i].result()
            except Exception:               # the chain after it fails too
                break
            i += 1
            if time.monotonic() < t0 + seconds:
                submit()
        results = []
        for f in segs + evals:
            try:
                results.append(f.result())
            except Exception as exc:
                self.failed += 1
                results.append(exc)
        sync(self.device)
        self.tracer.stop()
        self.attempted = len(segs) + len(evals)
        close = t0 + seconds
        seg_res = [(f, r) for f, r in zip(segs, results[:len(segs)])
                   if isinstance(r, dict)]
        counted = [(f, r) for f, r in seg_res if done_t[id(f)] <= close]
        tok = mx["batch"] * mx["seq"]
        self.evals_out = [r for r in results[len(segs):]]
        rec = {"kind": "train", "window_start": t0,
               "tokens": sum(r["n"] * tok for _, r in counted),
               "span_s": (max(done_t[id(f)] for f, _ in counted) - t0
                          if counted else None),
               "steps": sum(r["n"] for _, r in counted),
               "step_ms": [x for _, r in seg_res for x in r["step_ms"]],
               "shape": {"batch": mx["batch"], "seq": mx["seq"]}}
        self.window_tasks = [(f.task.uid, r["body_s"]) for f, r in seg_res]
        return rec

    def after(self, rec):
        """What the runtime's journal adds, once it is stopped."""
        rec["task_overhead_s"] = self.overheads(self.window_tasks)

    def judge(self, prec=None):
        """Reference readings: the first three steps and the held-out loss
        after the first segment, from the same weights and batches."""
        prec = prec or R.Precision("f32")
        params, stores = self.ref_params()
        n = self.mix["steps_per_segment"]
        to = lambda t: torch.from_numpy(t).to(self.device)
        batches = [(to(b[:, :-1]), to(b[:, 1:]))
                   for b in (self.batch(TRAIN, i) for i in range(max(3, n)))]
        h = self.batch(HELD_OUT, 0)
        with R.no_tf32():
            return R.train(self.ref, self.m, params, stores, batches,
                           (to(h[:, :-1]), to(h[:, 1:])), self.mix["optimizer"],
                           prec, eval_after=n)

    def compare(self, prog, ref):
        """The check's numbers: the widest loss gap of steps 1-3, the
        held-out loss's gap, and for the first gradient's norm and the
        change's norm after step 3 each leaf's gap over the larger of the
        reference's norm of that leaf and of the median leaf, taken by
        the worst leaf (``grad_gap``, ``change_gap``) and by the median
        leaf (``*_median``); leaves whose reference gradient is under a
        thousandth of the median leaf's are left out.  A cell's limits
        file says which of them it compares."""
        keys = ref["keys"]
        g_ref = np.array(ref["grad_norms"])
        keep = g_ref >= 1e-3 * float(np.median(g_ref))
        out = {"loss_gap": max(abs(a - b) for a, b in
                               zip(prog["losses"], ref["losses"])),
               "eval_gap": abs(prog["eval_loss"] - ref["eval_loss"])}
        for key, name in (("grad_norms", "grad_gap"),
                          ("change_norms", "change_gap")):
            p, r = np.array(prog[key]), np.array(ref[key])
            scale = np.maximum(r, float(np.median(r[keep])))
            gaps = np.where(keep, np.abs(p - r) / scale, 0.0)
            out[name] = float(gaps.max())
            out[name + "_median"] = float(np.median(gaps[keep]))
            out[name + "_leaf"] = keys[int(gaps.argmax())]
        out["left_out_leaves"] = int((~keep).sum())
        return out

    def window_sound(self):
        """Every window evaluation returned a finite loss."""
        return all(isinstance(r, dict) and np.isfinite(r["loss"])
                   for r in self.evals_out)


class PrepareAndScore(Workflow):
    def doc_tokens(self, stream, doc):
        mx = self.mix
        return W.tokens(self.seed, stream, doc, (mx["batch"], mx["seq"]),
                        self.m["vocab_size"]).astype(np.int32)

    def setup(self):
        from repro_torch.core import python_app, spmd_app
        from repro_torch.models import model as M
        mx = self.mix
        self.w = W.draw(self.leaves, self.seed, self.device, self.dtype)
        params = self.w.tree()
        prefill = M.make_prefill_step(self.cfg)
        tracer = self.tracer

        def prepare(stream, doc):
            t0 = time.perf_counter()
            with tracer.span("rpx.prepare"):
                toks = self.doc_tokens(stream, doc)
            return {"doc": doc, "tokens": toks,
                    "body_s": time.perf_counter() - t0}

        def score(mesh, prep):
            t0 = time.perf_counter()
            with tracer.span("rpx.score"):
                tok = torch.from_numpy(prep["tokens"]).to(mesh.device)
                timer = Timer(mesh.device).start()
                logits, _ = prefill(params, {"tokens": tok})
                timer.stop()
                out = logits[:, 0].to("cpu")
            return {"doc": prep["doc"], "logits": out, "step_ms": timer.ms(),
                    "body_s": time.perf_counter() - t0,
                    "prepare_s": prep["body_s"]}

        self.prepare = python_app(prepare)
        self.score = spmd_app(slots=mx["score_slots"], jit=False)(score)
        self.start_runtime()
        self.warm = self.score(self.prepare(WARM_DOC, 0)).result()
        sync(self.device)

    def window(self, seconds):
        mx = self.mix
        done = queue.Queue()
        self.docs = {}                          # doc -> [submitted, future]

        def submit():
            doc = len(self.docs)
            t = time.monotonic()
            p = self.prepare(DOCS, doc)
            f = self.score(p)
            self.docs[doc] = [t, p, f]
            f.add_done_callback(lambda f, d=doc: done.put((d,
                                                           time.monotonic())))

        self.tracer.start()
        t0 = time.monotonic()
        for _ in range(mx["in_flight"]):
            submit()
        in_flight, end_t = mx["in_flight"], {}
        while in_flight:
            d, t = done.get()
            end_t[d] = t
            in_flight -= 1
            if t < t0 + seconds:
                submit()
                in_flight += 1
        sync(self.device)
        self.tracer.stop()
        close = t0 + seconds
        self.results, lat, tasks = {}, [], []
        for d, (t_sub, p, f) in self.docs.items():
            try:
                r = f.result()
            except Exception:
                self.failed += 1
                continue
            self.results[d] = r
            tasks.append(((p.task.uid, r["prepare_s"]),
                          (f.task.uid, r["body_s"])))
            if end_t[d] <= close:
                lat.append(end_t[d] - t_sub)
        self.attempted = len(self.docs)
        counted = [d for d in self.results if end_t[d] <= close]
        self.doc_tasks = tasks
        return {"kind": "score", "window_start": t0,
                "tokens": len(counted) * mx["batch"] * mx["seq"],
                "span_s": (max(end_t[d] for d in counted) - t0
                           if counted else None),
                "latency_s": lat, "counted_docs": sorted(counted),
                "step_ms": [r["step_ms"] for r in self.results.values()],
                "shape": {"batch": mx["batch"], "seq": mx["seq"]}}

    def after(self, rec):
        per = []
        for pair in self.doc_tasks:
            o = self.overheads(list(pair))
            if len(o) == 2:
                per.append(sum(o))
        rec["task_overhead_s"] = per
        rec["misdelivered"] = sum(1 for d, r in self.results.items()
                                  if r["doc"] != d)

    def sample(self, counted):
        """The documents the check compares: ``check_docs`` of those
        finished in the window, drawn from the seed."""
        rng = np.random.default_rng([self.seed & W.SEED_MASK, DOCS])
        k = min(self.mix["check_docs"], len(counted))
        return sorted(rng.choice(counted, size=k, replace=False).tolist())

    def judge(self, prec=None, docs=None):
        """The reference's last-token logits of each sampled document."""
        prec = prec or R.Precision("f32")
        params, _ = self.ref_params()
        out = {}
        with R.no_tf32():
            for d in docs:
                tok = torch.from_numpy(self.doc_tokens(DOCS, d)).to(
                    self.device)
                out[d] = R.last_logits(self.ref, self.m, params, tok,
                                       prec).cpu()
        return out

    def compare(self, prog, ref):
        """The widest gap of a logit between the program's document and the
        reference's, over the sampled documents."""
        return {"logits_gap": max(float((prog[d].float() - ref[d]).abs()
                                        .max()) for d in ref)}


KINDS = {"train_and_evaluate": TrainAndEvaluate,
         "prepare_and_score": PrepareAndScore}
