"""Tokens of every document scored in the window, over the span from the
window's start to the last of them reaching the harness."""
from rpexbench.readers import rate


def read(rec):
    return rate(rec, "score")
