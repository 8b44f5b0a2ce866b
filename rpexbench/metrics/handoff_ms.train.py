"""Mean milliseconds from one ``train_segment`` body's end to the start of
the next one's, the segment its future fed, over the chained pairs whose
bodies both ran in the traced window: the producer's finish, the data-flow
kernel's launch of its consumer (a ``dfk.launch`` span, whose ``cause``
names the producers' tasks and ``tasks`` the tasks it launched), the
scheduling and the consumer's launch (the program's ``task.body`` spans,
``repro_torch.trace``)."""


def read(rec):
    if rec["kind"] != "train":
        return None
    try:
        from repro_torch.trace import snapshot
    except ImportError:             # a program without the recorder
        return None
    snap = snapshot()
    bodies = {s.task: s for s in snap.named("task.body")
              if s.attrs.get("fn") == "train_segment"}
    gaps = [bodies[c].start_ns - bodies[p].end_ns
            for launch in snap.named("dfk.launch")
            for c in launch.attrs.get("tasks", ()) if c in bodies
            for p in launch.attrs.get("cause", ()) if p in bodies]
    return sum(gaps) / len(gaps) / 1e6 if gaps else None
