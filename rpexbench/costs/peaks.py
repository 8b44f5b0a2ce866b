"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W)."""

BF16_FLOPS = 989e12        # FLOP/s on the tensor cores, bf16 and fp16
HBM_BYTES = 3.35e12        # bytes/s of HBM3


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for this work: the larger of
    its operations over the bf16 peak and its bytes over HBM's."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES)
