"""Mean device milliseconds of the optimizer's update in the traced window:
the CUDA events of the program's ``train.optimizer`` spans
(``repro_torch.trace``)."""


def read(rec):
    if rec["kind"] != "train":
        return None
    try:
        from repro_torch.trace import snapshot
    except ImportError:             # a program without the recorder
        return None
    ms = [s.device_ms for s in snapshot().named("train.optimizer")]
    ms = [x for x in ms if x is not None]
    return sum(ms) / len(ms) if ms else None
