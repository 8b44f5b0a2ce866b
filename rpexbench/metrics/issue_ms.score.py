"""Mean host milliseconds to issue a prefill step in the traced window: the
program's ``prefill.step`` spans (``repro_torch.trace``).  The traced run
profiles host ops on every thread, which slows them: this reads the
profiled host, above the untraced one."""


def read(rec):
    if rec["kind"] != "score":
        return None
    try:
        from repro_torch.trace import snapshot
    except ImportError:             # a program without the recorder
        return None
    ms = [s.ms for s in snapshot().named("prefill.step")]
    return sum(ms) / len(ms) if ms else None
