"""Model FLOPs of the window's training steps (6 x active parameters a
token) over the span times the bf16 peak, in %."""
from rpexbench.readers import mfu


def read(rec):
    return mfu(rec, "train", training=True)
