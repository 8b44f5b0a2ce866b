"""Mean host milliseconds to issue a train step in the traced window: the
program's ``train.step`` spans (``repro_torch.trace``).  The traced run
profiles host ops on every thread, which slows them: this reads the
profiled host, above the untraced one."""


def read(rec):
    if rec["kind"] != "train":
        return None
    try:
        from repro_torch.trace import snapshot
    except ImportError:             # a program without the recorder
        return None
    ms = [s.ms for s in snapshot().named("train.step")]
    return sum(ms) / len(ms) if ms else None
