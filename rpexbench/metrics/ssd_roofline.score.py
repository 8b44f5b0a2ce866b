"""K2 in the scoring window: the sum of each call's bound over the summed
device seconds of its kernels, in %."""
from rpexbench.readers import K2, roofline_pct, ssd_costs


def read(rec):
    if rec["kind"] != "score":
        return None
    return roofline_pct(rec, [("ssd_chunk_kernel", K2, ssd_costs(rec)[0])])
