"""Host milliseconds a train step spends inside the mixers' spans
(``layer.attn``, ``layer.local_attn``, ``layer.mamba``) on every thread:
the forward on the task's thread and the remat recompute on autograd's,
summed over the traced window's ``train.step`` spans and divided by their
count (the program's recorder, ``repro_torch.trace``).  Host time of the
traced run, whose profiler of host ops slows them: above the untraced
one."""

MIXERS = ("layer.attn", "layer.local_attn", "layer.mamba")


def read(rec):
    if rec["kind"] != "train":
        return None
    try:
        from repro_torch.trace import snapshot
    except ImportError:             # a program without the recorder
        return None
    snap = snapshot()
    steps = snap.named("train.step")
    if not steps:
        return None
    ms = sum(s.ms for s in snap.named(*MIXERS)
             if s.enclosing("train.step") is not None)
    return ms / len(steps)
