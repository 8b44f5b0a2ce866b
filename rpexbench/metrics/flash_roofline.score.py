"""K1 in the scoring window: the sum of each call's bound over the summed
device seconds of its kernels, in %."""
from rpexbench.readers import K1, flash_costs, roofline_pct


def read(rec):
    if rec["kind"] != "score":
        return None
    return roofline_pct(rec, [("flash_attention_fwd", K1,
                               flash_costs(rec)[0])])
