"""Mamba2 SSD intra-chunk terms: the CUDA kernel's wrapper and its plain version.

``ssd_chunk_kernel`` launches ``csrc/ssd_chunk.cu`` (CUDA C++ for Hopper,
``sm_90a``), the port of the Pallas TPU kernel ``repro.kernels.ssd._kernel``,
with the output contract of ``repro.kernels.ssd.ssd_chunk_kernel``.  It
takes CUDA tensors only and raises on anything the kernel does not take;
``ssd_chunk_plain`` is the same function in plain PyTorch.
``ops.ssd_chunk`` chooses between them by the tensors' device.

``ssd_chunk_kernel.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import ssd_chunk_terms

MAX_HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _chunks(x, chunk):
    S = x.shape[1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd_chunk: seq {S} not divisible by chunk {Q}")
    return Q, S // Q


def ssd_chunk_plain(x, dt, A, B_, C_, *, chunk: int):
    """All chunks' intra-chunk terms at once, through ``ssd_chunk_terms``.

    x: (B,S,H,P); dt: (B,S,H); A: (H,); B_/C_: (B,S,N), each upcast to f32.
    Returns y_intra (B,S,H,P), states (B,H,nc,P,N), decay_all (B,H,nc,Q),
    decay_chunk (B,H,nc), all f32.
    """
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    Q, nc = _chunks(x, chunk)
    y, st, dall, dch = ssd_chunk_terms(
        x.float().reshape(Bsz * nc, Q, H, P), dt.float().reshape(Bsz * nc, Q, H),
        A.float(), B_.float().reshape(Bsz * nc, Q, N),
        C_.float().reshape(Bsz * nc, Q, N))
    return (y.reshape(Bsz, S, H, P),
            st.reshape(Bsz, nc, H, P, N).transpose(1, 2),
            dall.reshape(Bsz, nc, H, Q).transpose(1, 2),
            dch.reshape(Bsz, nc, H).transpose(1, 2))


@functools.cache
def _bind():
    lib = _build.load("ssd_chunk")
    fn = lib.ssd_chunk
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _check_inputs(x, dt, A, B_, C_):
    named = (("x", x), ("dt", dt), ("A", A), ("B_", B_), ("C_", C_))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"ssd_chunk_kernel: {name} is on {t.device}, "
                             "the kernel takes CUDA tensors")
        if t.numel() == 0:
            raise ValueError(f"ssd_chunk_kernel: {name} is empty")
    if len({t.device for _, t in named}) != 1:
        raise ValueError("ssd_chunk_kernel: inputs on different devices")
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B_.dim() != 3 \
            or C_.dim() != 3:
        raise ValueError("ssd_chunk_kernel: expected x (B,S,H,P), dt (B,S,H), "
                         "A (H,), B_/C_ (B,S,N)")
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    if dt.shape != (Bsz, S, H) or A.shape != (H,) or \
            B_.shape != (Bsz, S, N) or C_.shape != (Bsz, S, N):
        raise ValueError(
            f"ssd_chunk_kernel: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"A {tuple(A.shape)}, B_ {tuple(B_.shape)}, C_ {tuple(C_.shape)} "
            "disagree")
    if x.dtype not in _DTYPE_CODE or not (x.dtype == B_.dtype == C_.dtype):
        raise ValueError("ssd_chunk_kernel: x, B_, C_ must all be float32 or "
                         f"all bfloat16, got {x.dtype}, {B_.dtype}, {C_.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"ssd_chunk_kernel: dt and A must be float32, got "
                         f"{dt.dtype}, {A.dtype}")
    if P > MAX_HEAD_DIM:
        raise ValueError(f"ssd_chunk_kernel: head dim {P} > {MAX_HEAD_DIM}")
    # x: heads packed at stride P, elements at stride 1 (a split view of
    # the model's xBC qualifies); B_/C_: unit stride along N; the batch and
    # sequence strides are passed to the kernel
    if x.stride(3) != 1 or (H > 1 and x.stride(2) != P):
        raise ValueError(f"ssd_chunk_kernel: x strides {x.stride()} need "
                         f"(., ., {P}, 1)")
    for name, t in (("B_", B_), ("C_", C_)):
        if t.stride(2) != 1:
            raise ValueError(f"ssd_chunk_kernel: {name} strides {t.stride()} "
                             "need unit stride along N")
    if not (dt.is_contiguous() and A.is_contiguous()):
        raise ValueError("ssd_chunk_kernel: dt and A must be contiguous")


def ssd_chunk_kernel(x, dt, A, B_, C_, *, chunk: int):
    """The CUDA kernel: same contract as :func:`ssd_chunk_plain`.

    Launches on the current stream and does not synchronise.
    """
    _check_inputs(x, dt, A, B_, C_)
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    Q, nc = _chunks(x, chunk)
    lib, fn = _bind()
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((Bsz, S, H, P), **f32)
    st = torch.empty((Bsz, H, nc, P, N), **f32)
    dall = torch.empty((Bsz, H, nc, Q), **f32)
    dch = torch.empty((Bsz, H, nc), **f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
                 C_.data_ptr(), y.data_ptr(), st.data_ptr(), dall.data_ptr(),
                 dch.data_ptr(), Bsz, S, H, P, N, Q, _DTYPE_CODE[x.dtype],
                 x.stride(0), x.stride(1), B_.stride(0), B_.stride(1),
                 C_.stride(0), C_.stride(1), stream)
    _build.check(lib, err, "ssd_chunk_kernel launch")
    ssd_chunk_kernel.launches += 1
    return y, st, dall, dch


ssd_chunk_kernel.launches = 0

__all__ = ["ssd_chunk_kernel", "ssd_chunk_plain", "MAX_HEAD_DIM"]
