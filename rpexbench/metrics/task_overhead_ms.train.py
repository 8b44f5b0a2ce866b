"""Mean over the window's ``train_segment`` tasks of the task's first
journal event to DONE, less its body's seconds (measured by the body,
after a synchronize) and any wait for slots other tasks held
(``Workflow.overheads``)."""
from rpexbench.readers import mean


def read(rec):
    if rec["kind"] != "train" or not rec["task_overhead_s"]:
        return None
    return 1e3 * mean(rec["task_overhead_s"])
