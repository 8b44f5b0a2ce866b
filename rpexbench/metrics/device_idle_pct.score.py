"""Share of the traced scoring window in which nothing ran on the card,
in %."""
from rpexbench.readers import idle_pct


def read(rec):
    return idle_pct(rec, "score")
