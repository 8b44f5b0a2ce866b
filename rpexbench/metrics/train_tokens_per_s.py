"""Training tokens of every step of the segments finished in the window,
over the span from the window's start to the end of the last of them."""
from rpexbench.readers import rate


def read(rec):
    return rate(rec, "train")
