"""K1 and K1b in the training window (the evaluations' K1 calls with
them): the sum of each call's bound over the summed device seconds of
their kernels, in %."""
from rpexbench.readers import K1, K1B, flash_costs, roofline_pct


def read(rec):
    if rec["kind"] != "train":
        return None
    fwd, bwd = flash_costs(rec)
    return roofline_pct(rec, [("flash_attention_fwd", K1, fwd),
                              ("flash_attention_bwd", K1B, bwd)])
