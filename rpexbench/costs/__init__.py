"""The yardstick of work: each kernel's FLOPs and HBM bytes from its
shapes, the model FLOPs a token, and the card's peaks.  Frozen copies of
the formulas, so that a share of a roofline reads the same work whatever
implements the kernel."""
