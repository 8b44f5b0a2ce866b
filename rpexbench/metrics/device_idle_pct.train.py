"""Share of the traced training window in which nothing ran on the card:
1 less the union of its kernels, copies and fills over the window, in %."""
from rpexbench.readers import idle_pct


def read(rec):
    return idle_pct(rec, "train")
