"""K2b, the SSD chunk kernel's backward: FLOPs and bytes of one call.

The VJP's products: three of the C B^T kind, two with x, two of the
state kind; K2's inputs and its four cotangents read once, dx, ddt, dA,
dB and dC written once.
"""
from __future__ import annotations

from .ssd_chunk import dims


def cost(b: int, s: int, h: int, p: int, n: int, chunk: int, *,
         itemsize: int = 2):
    """(FLOPs, bytes) of K2b for K2's inputs of these shapes."""
    q, nc, tri = dims(s, chunk)
    flops = 2 * (3 * n * b * nc * tri + 2 * p * b * h * nc * tri
                 + 2 * b * h * nc * q * p * n)
    x_bytes, bc_bytes = b * s * h * p * itemsize, b * s * n * itemsize
    nbytes = (2 * x_bytes + 2 * bc_bytes + 4 * (b * s * h + h)
              + 4 * (b * s * h * p + b * h * nc * (p * n + q + 1))
              + 4 * (b * s * h + h + 2 * b * s * n))
    return flops, nbytes
