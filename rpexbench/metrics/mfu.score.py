"""Model FLOPs of the window's scored documents (2 x active parameters a
token) over the span times the bf16 peak, in %."""
from rpexbench.readers import mfu


def read(rec):
    return mfu(rec, "score", training=False)
