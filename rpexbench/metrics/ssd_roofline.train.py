"""K2 and K2b in the training window: the sum of each call's bound
(max(FLOPs / bf16 peak, bytes / HBM rate), frozen costs at the cell's
shapes) over the summed device seconds of their kernels, in %."""
from rpexbench.readers import K2, K2B, roofline_pct, ssd_costs


def read(rec):
    if rec["kind"] != "train":
        return None
    fwd, bwd = ssd_costs(rec)
    return roofline_pct(rec, [("ssd_chunk_kernel", K2, fwd),
                              ("ssd_chunk_bwd_kernel", K2B, bwd)])
