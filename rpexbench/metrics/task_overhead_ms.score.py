"""Mean over the window's documents of the runtime's time around their
``prepare`` and ``score`` tasks: each task's first journal event to DONE
less its body's seconds and its wait for the slots of the score before it
(``Workflow.overheads``), summed over the document's two tasks."""
from rpexbench.readers import mean


def read(rec):
    if rec["kind"] != "score" or not rec["task_overhead_s"]:
        return None
    return 1e3 * mean(rec["task_overhead_s"])
