"""K2, the SSD chunk kernel: FLOPs and bytes of one call.

FLOPs: C B^T once per (batch, chunk) over the chunk's causal pairs, the
masked product with x per head, and each chunk's state; bytes: x, dt, A,
B and C read once, y_intra, the states and both decays written once, in
f32.
"""
from __future__ import annotations


def dims(s: int, chunk: int):
    """(Q, number of chunks, causal pairs in a chunk)."""
    q = min(chunk, s)
    return q, s // q, q * (q + 1) // 2


def cost(b: int, s: int, h: int, p: int, n: int, chunk: int, *,
         itemsize: int = 2):
    """(FLOPs, bytes) of K2 on x (b, s, h, p), dt (b, s, h) f32, A (h,)
    f32 and B, C (b, s, n)."""
    q, nc, tri = dims(s, chunk)
    flops = 2 * (n * b * nc * tri + p * b * h * nc * tri
                 + b * h * nc * q * p * n)
    x_bytes, bc_bytes = b * s * h * p * itemsize, b * s * n * itemsize
    nbytes = (x_bytes + 2 * bc_bytes + 4 * (b * s * h + h)
              + 4 * (b * s * h * p + b * h * nc * (p * n + q + 1)))
    return flops, nbytes
