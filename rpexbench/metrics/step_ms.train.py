"""Mean device time of a train step in the traced window: CUDA events
around each ``step_fn`` call inside the segment bodies."""
from rpexbench.readers import mean


def read(rec):
    if rec["kind"] != "train" or not rec["step_ms"]:
        return None
    return mean(rec["step_ms"])
