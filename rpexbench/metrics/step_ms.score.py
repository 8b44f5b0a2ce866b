"""Mean device time of a prefill step in the traced window: CUDA events
around each ``prefill_step`` call inside the score bodies."""
from rpexbench.readers import mean


def read(rec):
    if rec["kind"] != "score" or not rec["step_ms"]:
        return None
    return mean(rec["step_ms"])
