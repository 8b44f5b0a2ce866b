"""Mamba2 SSD intra-chunk terms, forward and backward: the CUDA kernels'
wrappers and their plain versions.

``ssd_chunk_kernel`` launches ``csrc/ssd_chunk.cu`` (K2, CUDA C++ for
Hopper, ``sm_90a``), the port of the Pallas TPU kernel
``repro.kernels.ssd._kernel``, with the output contract of
``repro.kernels.ssd.ssd_chunk_kernel``.  ``ssd_chunk_bwd_kernel`` launches
``csrc/ssd_chunk_bwd.cu`` (K2b), the VJP of K2's four terms with respect to
x, dt, A, B and C: the counterpart of the reference's jnp custom VJP
``repro.kernels.ops._ssd_bwd``.  Both take CUDA tensors only and raise on
anything their kernel does not take; ``ssd_chunk_plain`` and
``ssd_chunk_bwd_plain`` are the same functions in plain PyTorch.
``ops.ssd_chunk`` and ``ops.ssd_chunk_grads`` choose between them by the
tensors' device.

``ssd_chunk_kernel.launches`` and ``ssd_chunk_bwd_kernel.launches`` count
the calls that launch each kernel.  K2b's call is five CUDA launches for
bf16 inputs, on the tensor cores (C B^T per chunk; per head the pairs
within the chunk and the chunk state's share of dx; dCB and the chunk
state's share of dB, each summed over heads; dB's and dC's products with
dCB; dA's sum) and six for f32, on the CUDA cores.

Two routes for bf16 inputs, chosen by :func:`ssd_route` from the shapes and
the layout alone, never after a failure: ``"wgmma"`` (Hopper's ``wgmma``
fed by TMA) at the models' full widths, P = 64 or 128, N a multiple of 16
up to 256, a chunk Q a multiple of 64 up to 256, with x, B and C as TMA
reads them (16-byte aligned, batch and sequence strides multiples of 8
elements, as the model's split views of xBC are); ``"mma"`` (``mma.sync``)
for every other bf16 shape.  f32 inputs take ``"f32"`` (CUDA cores).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import ssd_chunk_bwd_plain, ssd_chunk_plain, ssd_chunks

MAX_HEAD_DIM = 128
MAX_STATE_BWD = 256     # K2b: the state dim N it takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


_ROUTE_CODE = {"f32": 0, "mma": 0, "wgmma": 1}


def ssd_route(x, B_, C_, chunk: int) -> str:
    """The route K2 and K2b take for these inputs: ``"f32"``, ``"mma"``
    or ``"wgmma"`` (the rule in the module's note; the CUDA sources check
    the same rule)."""
    if x.dtype != torch.bfloat16:
        return "f32"
    P, N = x.shape[-1], B_.shape[-1]
    Q = min(chunk, x.shape[1])
    tma = all(t.data_ptr() % 16 == 0 for t in (x, B_, C_)) and all(
        st % 8 == 0 for st in (x.stride(0), x.stride(1), B_.stride(0),
                               B_.stride(1), C_.stride(0), C_.stride(1)))
    if P in (64, 128) and N % 16 == 0 and N <= 256 and Q % 64 == 0 \
            and Q <= 256 and tma:
        return "wgmma"
    return "mma"


@functools.cache
def _bind():
    lib = _build.load("ssd_chunk")
    fn = lib.ssd_chunk
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.ssd_chunk_workspace.argtypes = [ctypes.c_int] * 5
    lib.ssd_chunk_workspace.restype = ctypes.c_longlong
    return lib, fn


def _check_inputs(x, dt, A, B_, C_, what="ssd_chunk_kernel"):
    named = (("x", x), ("dt", dt), ("A", A), ("B_", B_), ("C_", C_))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}, "
                             "the kernel takes CUDA tensors")
        if t.numel() == 0:
            raise ValueError(f"{what}: {name} is empty")
    if len({t.device for _, t in named}) != 1:
        raise ValueError(f"{what}: inputs on different devices")
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B_.dim() != 3 \
            or C_.dim() != 3:
        raise ValueError(f"{what}: expected x (B,S,H,P), dt (B,S,H), "
                         "A (H,), B_/C_ (B,S,N)")
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    if dt.shape != (Bsz, S, H) or A.shape != (H,) or \
            B_.shape != (Bsz, S, N) or C_.shape != (Bsz, S, N):
        raise ValueError(
            f"{what}: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"A {tuple(A.shape)}, B_ {tuple(B_.shape)}, C_ {tuple(C_.shape)} "
            "disagree")
    if x.dtype not in _DTYPE_CODE or not (x.dtype == B_.dtype == C_.dtype):
        raise ValueError(f"{what}: x, B_, C_ must all be float32 or "
                         f"all bfloat16, got {x.dtype}, {B_.dtype}, {C_.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"{what}: dt and A must be float32, got "
                         f"{dt.dtype}, {A.dtype}")
    if P > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {P} > {MAX_HEAD_DIM}")
    # x: heads packed at stride P, elements at stride 1 (a split view of
    # the model's xBC qualifies); B_/C_: unit stride along N; the batch and
    # sequence strides are passed to the kernel
    if x.stride(3) != 1 or (H > 1 and x.stride(2) != P):
        raise ValueError(f"{what}: x strides {x.stride()} need "
                         f"(., ., {P}, 1)")
    for name, t in (("B_", B_), ("C_", C_)):
        if t.stride(2) != 1:
            raise ValueError(f"{what}: {name} strides {t.stride()} "
                             "need unit stride along N")
    if not (dt.is_contiguous() and A.is_contiguous()):
        raise ValueError(f"{what}: dt and A must be contiguous")


def ssd_chunk_kernel(x, dt, A, B_, C_, *, chunk: int):
    """The CUDA kernel: same contract as :func:`ssd_chunk_plain`.

    Launches on the current stream and does not synchronise.
    """
    _check_inputs(x, dt, A, B_, C_)
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    Q, nc = ssd_chunks(x, chunk)
    route = _ROUTE_CODE[ssd_route(x, B_, C_, chunk)]
    lib, fn = _bind()
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((Bsz, S, H, P), **f32)
    st = torch.empty((Bsz, H, nc, P, N), **f32)
    dall = torch.empty((Bsz, H, nc, Q), **f32)
    dch = torch.empty((Bsz, H, nc), **f32)
    # the wgmma route's scratch: each head's cum, dt and factors per chunk
    work = torch.empty((lib.ssd_chunk_workspace(Bsz, S, H, Q, route),),
                       dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
                 C_.data_ptr(), y.data_ptr(), st.data_ptr(), dall.data_ptr(),
                 dch.data_ptr(), work.data_ptr(), Bsz, S, H, P, N, Q,
                 _DTYPE_CODE[x.dtype], route,
                 x.stride(0), x.stride(1), B_.stride(0), B_.stride(1),
                 C_.stride(0), C_.stride(1), stream)
    _build.check(lib, err, "ssd_chunk_kernel launch")
    _build.count_launch(ssd_chunk_kernel)
    return y, st, dall, dch


ssd_chunk_kernel.launches = 0


@functools.cache
def _bind_bwd():
    lib = _build.load("ssd_chunk_bwd")
    fn = lib.ssd_chunk_bwd
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.ssd_chunk_bwd_workspace.argtypes = [ctypes.c_int] * 7
    lib.ssd_chunk_bwd_workspace.restype = ctypes.c_longlong
    return lib, fn


def _check_cotangents(x, N, Q, nc, dy, dstates, ddall, ddchunk):
    Bsz, S, H, P = x.shape
    for name, t, shape in (("dy", dy, (Bsz, S, H, P)),
                           ("dstates", dstates, (Bsz, H, nc, P, N)),
                           ("ddall", ddall, (Bsz, H, nc, Q)),
                           ("ddchunk", ddchunk, (Bsz, H, nc))):
        if t.device != x.device:
            raise ValueError(f"ssd_chunk_bwd_kernel: {name} is on {t.device}, "
                             f"x on {x.device}")
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"ssd_chunk_bwd_kernel: {name} must be contiguous "
                             f"float32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def ssd_chunk_bwd_kernel(x, dt, A, B_, C_, dy, dstates, ddall, ddchunk, *,
                         chunk: int):
    """The CUDA backward kernel: same contract as
    :func:`ssd_chunk_bwd_plain`, (dx in x's type, ddt, dA, dB, dC f32).

    x, dt, A, B_, C_ as :func:`ssd_chunk_kernel` takes them (x, B_ and C_
    read in place through their strides); the cotangents contiguous f32.
    dx is summed in f32 and rounded once to x's type as it is written.
    Deterministic: no atomics; the sums over heads (dB, dC) and over
    batch and chunks (dA) run in a fixed order.  Launches on the current
    stream and does not synchronise.
    """
    _check_inputs(x, dt, A, B_, C_, "ssd_chunk_bwd_kernel")
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    if N > MAX_STATE_BWD:
        raise ValueError(f"ssd_chunk_bwd_kernel: state dim {N} > "
                         f"{MAX_STATE_BWD}")
    Q, nc = ssd_chunks(x, chunk)
    _check_cotangents(x, N, Q, nc, dy, dstates, ddall, ddchunk)
    lib, fn = _bind_bwd()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    ddt = torch.empty((Bsz, S, H), **f32)
    dA = torch.empty((H,), **f32)
    dB = torch.empty((Bsz, S, N), **f32)
    dC = torch.empty((Bsz, S, N), **f32)
    # one workspace for the kernels' scratch: bf16, C B^T per chunk, dCB and
    # the chunk state's share of dB per group of heads, cum, w, dt and a
    # column factor per head, dA's shares (~44 MB at the mamba2 shape);
    # f32, per-head partials
    code = _DTYPE_CODE[x.dtype]
    route = _ROUTE_CODE[ssd_route(x, B_, C_, chunk)]
    work = torch.empty((lib.ssd_chunk_bwd_workspace(Bsz, S, H, P, N, Q, code),),
                       dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
                 C_.data_ptr(), dy.data_ptr(), dstates.data_ptr(),
                 ddall.data_ptr(), ddchunk.data_ptr(), dx.data_ptr(),
                 ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                 work.data_ptr(), Bsz, S, H, P, N, Q, code, route,
                 x.stride(0), x.stride(1), B_.stride(0), B_.stride(1),
                 C_.stride(0), C_.stride(1), stream)
    _build.check(lib, err, "ssd_chunk_bwd_kernel launch")
    _build.count_launch(ssd_chunk_bwd_kernel)
    return dx, ddt, dA, dB, dC


ssd_chunk_bwd_kernel.launches = 0

__all__ = ["ssd_chunk_kernel", "ssd_chunk_plain", "ssd_chunk_bwd_kernel",
           "ssd_chunk_bwd_plain", "ssd_route", "MAX_HEAD_DIM", "MAX_STATE_BWD"]
