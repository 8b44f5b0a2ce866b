"""What each of the port's kernels costs: its FLOPs and HBM bytes.

One function per kernel, from the call's shapes, dtypes and options, so
that ``chip_smoke.py``'s bounds and the step counter of
``repro_torch.roofline`` use one yardstick.  FLOPs count the matrix
products only, 2 per multiply-add (softmax, exp and masks are left out, as
the card's tensor-core peak leaves them out); bytes count each input read
once and each output written once, the traffic a kernel that keeps its
tiles on chip must move:

* K1, ``flash_attention_fwd``: q.k and p.v over the (q, kv) pairs the
  causal mask, the window and ``q_offset`` leave; q, k, v read, o written
  (and lse, f32, where the call writes it).
* K1b, ``flash_attention_bwd``: five products over the same pairs (the
  kernel recomputes the scores and issues seven; the bound counts five);
  q, k, v, o, do and lse read, dq, dk, dv written.
* K2, ``ssd_chunk_kernel``: C B^T once per (batch, chunk), the masked
  product with x per head and the chunk state; x, dt, A, B, C read,
  y_intra, the states and both decays written, in f32.
* K2b, ``ssd_chunk_bwd_kernel``: the VJP's products (three of the C B^T
  kind, two with x, two of the state kind); the forward's inputs and the
  four cotangents read, dx, ddt, dA, dB, dC written.
* K3, ``ssd_pass_kernel``: C h_prev^T per (batch, chunk, head); K2's
  four terms, C and h0 read, y (in C's type), the final state and the
  state entering each chunk (saved for K3b) written.
* K3b, ``ssd_pass_bwd_kernel``: three products of that size (C h_prev^T
  for d decay_all, g h_prev for dC, g^T C for the states' gradient); dy
  (in C's type), dhT, the saved states, both decays and C read, the
  gradients of K3's inputs (K2's four terms, C, h0) written, in f32.

:func:`counted` is the hook through which a kernel's wrapper reports its
cost to whatever counter is running (``repro_torch.roofline.counter``);
with none running it does nothing.
"""
from __future__ import annotations

import contextlib
from typing import List, NamedTuple

import numpy as np


class Cost(NamedTuple):
    flops: int
    bytes: int


def attention_pairs(Sq: int, Skv: int, *, causal: bool = True,
                    window: int = 0, q_offset: int = 0) -> int:
    """The (q row, kv column) pairs a head computes: row i at position
    ``q_offset + i`` sees key j where j <= that position (causal) and
    j > position - window (a window), as the kernels' masks."""
    pos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(pos, Skv - 1) if causal else np.full(Sq, Skv - 1,
                                                         np.int64)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_fwd_cost(q, k, *, causal: bool = True, window: int = 0,
                   q_offset: int = 0, with_lse: bool = False) -> Cost:
    """K1 on q (B,Sq,Hq,D) against k and v (B,Skv,Hkv,D)."""
    B, Sq, Hq, D = q.shape
    Skv = k.shape[1]
    pairs = attention_pairs(Sq, Skv, causal=causal, window=window,
                            q_offset=q_offset)
    nbytes = 2 * _nbytes(q) + 2 * _nbytes(k)
    if with_lse:
        nbytes += 4 * B * Sq * Hq
    return Cost(4 * D * pairs * B * Hq, nbytes)


def flash_bwd_cost(q, k, *, causal: bool = True, window: int = 0,
                   q_offset: int = 0) -> Cost:
    """K1b: (dq, dk, dv) from q, k, v, o, lse and do."""
    B, Sq, Hq, D = q.shape
    Skv = k.shape[1]
    pairs = attention_pairs(Sq, Skv, causal=causal, window=window,
                            q_offset=q_offset)
    nbytes = 4 * _nbytes(q) + 4 * _nbytes(k) + 4 * B * Sq * Hq
    return Cost(2 * 5 * D * pairs * B * Hq, nbytes)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _ssd_dims(x, B_, chunk):
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    return Bsz, S, H, P, N, Q, S // Q, Q * (Q + 1) // 2


def ssd_chunk_cost(x, B_, *, chunk: int) -> Cost:
    """K2 on x (B,S,H,P), dt (B,S,H) f32, A (H,) f32, B_/C_ (B,S,N)."""
    Bsz, S, H, P, N, Q, nc, tri = _ssd_dims(x, B_, chunk)
    flops = 2 * (N * Bsz * nc * tri + P * Bsz * H * nc * tri
                 + Bsz * H * nc * Q * P * N)
    nbytes = (_nbytes(x) + 2 * _nbytes(B_) + 4 * (Bsz * S * H + H)
              + 4 * (Bsz * S * H * P + Bsz * H * nc * (P * N + Q + 1)))
    return Cost(flops, nbytes)


def ssd_chunk_bwd_cost(x, B_, *, chunk: int) -> Cost:
    """K2b: (dx, ddt, dA, dB, dC) from K2's inputs and its four
    cotangents."""
    Bsz, S, H, P, N, Q, nc, tri = _ssd_dims(x, B_, chunk)
    flops = 2 * (3 * N * Bsz * nc * tri + 2 * P * Bsz * H * nc * tri
                 + 2 * Bsz * H * nc * Q * P * N)
    nbytes = (2 * _nbytes(x) + 2 * _nbytes(B_) + 4 * (Bsz * S * H + H)
              + 4 * (Bsz * S * H * P + Bsz * H * nc * (P * N + Q + 1))
              + 4 * (Bsz * S * H + H + 2 * Bsz * S * N))
    return Cost(flops, nbytes)


def _pass_dims(y_like, states_like):
    Bsz, S, H, P = y_like.shape
    nc, N = states_like.shape[2], states_like.shape[-1]
    return Bsz, S, H, P, N, nc


def ssd_pass_cost(y_intra, states, C_, *, with_h0: bool) -> Cost:
    """K3 on y_intra (B,S,H,P), states (B,H,nc,P,N) and C_ (B,S,N)."""
    Bsz, S, H, P, N, nc = _pass_dims(y_intra, states)
    state = 4 * Bsz * H * P * N
    nbytes = (4 * Bsz * S * H * P + 2 * 4 * Bsz * H * nc * P * N
              + 4 * Bsz * H * (S + nc) + _nbytes(C_)
              + C_.element_size() * Bsz * S * H * P
              + state * (1 + with_h0))
    return Cost(2 * Bsz * S * H * P * N, nbytes)


def ssd_pass_bwd_cost(dy, h_prev, C_, *, with_dhT: bool,
                      with_dh0: bool) -> Cost:
    """K3b: the gradients of K3's inputs from dy, dhT and what K3 saved."""
    Bsz, S, H, P, N, nc = _pass_dims(dy, h_prev)
    state = 4 * Bsz * H * P * N
    nbytes = (C_.element_size() * Bsz * S * H * P + 2 * 4 * Bsz * H * nc * P * N
              + 2 * 4 * Bsz * H * (S + nc) + _nbytes(C_)
              + 4 * Bsz * S * H * P + 4 * Bsz * S * N
              + state * (with_dhT + with_dh0))
    return Cost(6 * Bsz * S * H * P * N, nbytes)


# ------------------------------ the hook ------------------------------- #

_COUNTERS: List = []     # running counters, innermost last


@contextlib.contextmanager
def counted(name: str, cost_fn):
    """Around a kernel wrapper's route: the innermost running counter adds
    ``cost_fn()`` under ``name`` and counts none of the route's own ops
    (the plain version's score-sized products, the kernel's allocations);
    the caller hands it the route's outputs through the yielded
    function, which it then tracks as live.  With no counter running,
    ``cost_fn`` is not called and the outputs are not looked at."""
    if not _COUNTERS:
        yield lambda outs: outs
        return
    counter = _COUNTERS[-1]
    with counter.kernel(name, cost_fn()) as track:
        yield track
