"""The traced run's profiler and its reduction to aggregates.

``Tracer(True)`` runs ``torch.profiler`` (host ops and the card's
activity) over the whole window and keeps only aggregates of it: the
device's busy seconds (the union of every kernel, copy and fill on the
card) within the traced window, each kernel's summed device seconds by
name, the device operations that took the most time, and the idle gaps
summed by what the host was doing while the card waited: the innermost
host op on a thread at the gap's middle, under the harness's own range
(``rpx.*``) around it; and how many calls of each of the port's kernels
the window launched (their wrappers' counters).  No trace is written out.  ``Tracer(False)``
does nothing, and its spans cost nothing.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from collections import defaultdict

TOP = 10
SMALL_GAP_NS = 10_000           # gaps shorter than this are launch latency


class Tracer:
    def __init__(self, enabled: bool, device):
        self.on = enabled
        self.cuda = device.type == "cuda"
        self.summary = None
        self._prof = None

    def span(self, name: str):
        """A host range of the harness (``rpx.<name>``) in the trace."""
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def start(self):
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self._launches = launch_counts()
        self._prof = profile(activities=acts,
                             experimental_config=all_threads())
        self._prof.__enter__()
        self._t0 = time.time_ns()

    def stop(self):
        if not self.on:
            return
        self._t1 = time.time_ns()
        with warnings.catch_warnings():
            # "Profiler clears events at the end of each cycle": one cycle
            warnings.simplefilter("ignore", UserWarning)
            self._prof.__exit__(None, None, None)
        t = time.perf_counter()
        self.summary = reduce(self._prof.profiler.kineto_results.events(),
                              self._t0, self._t1)
        self.summary["reduce_s"] = time.perf_counter() - t
        self.summary["launches"] = {k: v - self._launches[k]
                                    for k, v in launch_counts().items()}
        self._prof = None


def all_threads():
    """The profiler's option to record host ops on every thread (the
    pilot's tasks run on its agent's threads), where this torch has it."""
    import torch
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


def launch_counts():
    """The port's kernel wrappers' launch counters (K1, K1b, K2, K2b)."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    from repro_torch.kernels.ssd import ssd_chunk_bwd_kernel, ssd_chunk_kernel
    return {f.__name__: f.launches for f in (
        flash_attention_fwd, flash_attention_bwd, ssd_chunk_kernel,
        ssd_chunk_bwd_kernel)}


def _is_device(e) -> bool:
    from torch.autograd import DeviceType
    if e.device_type() != DeviceType.CUDA:
        return False
    return not e.is_user_annotation()


def reduce(events, t0: int, t1: int) -> dict:
    """Aggregates of the profiler's events over the window [t0, t1] (ns of
    the profiler's clock)."""
    dev, host = [], []
    kernels = defaultdict(float)
    for e in events:
        s = e.start_ns()
        end = s + e.duration_ns()
        if _is_device(e):
            dev.append((s, end))
            kernels[e.name()] += (end - s) / 1e9
        elif e.name().startswith(("aten::", "rpx.")) or "cuda" in e.name():
            host.append((s, end, e.start_thread_id(), e.name()))
    dev.sort()
    busy, gaps, cur = 0, [], t0
    for s, end in dev:
        s, end = max(s, t0), min(end, t1)
        if end <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
            busy += end - s
        else:
            busy += end - cur
        cur = end
    if cur < t1:
        gaps.append((cur, t1))
    ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy / 1e9, "window_s": (t1 - t0) / 1e9,
            "kernels": dict(kernels),
            "device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": label_gaps(gaps, host)}


def label_gaps(gaps, host):
    """Idle seconds summed by label, the TOP largest: gaps under
    SMALL_GAP_NS together, each longer gap by the host op at its middle."""
    totals = defaultdict(float)
    probes = []
    for s, end in gaps:
        if end - s < SMALL_GAP_NS:
            totals["gaps under 10 us (launch latency)"] += (end - s) / 1e9
        else:
            probes.append(((s + end) // 2, (end - s) / 1e9))
    probes.sort()
    host.sort()
    stacks = defaultdict(list)          # thread -> nested open ops
    j = 0
    for t, secs in probes:
        while j < len(host) and host[j][0] <= t:
            s, end, th, name = host[j]
            st = stacks[th]
            while st and st[-1][1] < s:
                st.pop()
            st.append((s, end, name))
            j += 1
        best = None
        for st in stacks.values():
            while st and st[-1][1] < t:
                st.pop()
            live = [op for op in st if op[1] >= t]
            if not live:
                continue
            ranges = [op[2] for op in live if op[2].startswith("rpx.")]
            inner = live[-1]
            # a thread inside an op (the backward's autograd thread among
            # them) over one that waits in a harness range
            cand = (not inner[2].startswith("rpx."), inner[0],
                    ranges[0] if ranges else "", inner[2])
            if best is None or cand[:2] > best[:2]:
                best = cand
        if best is None:
            label = "no host op (runtime threads, Python)"
        elif not best[0]:
            label = f"{best[2]}: Python"
        else:
            label = f"{best[2] or 'thread outside rpx (autograd)'}: {best[3]}"
        totals[label] += secs
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])
            [:TOP]]
