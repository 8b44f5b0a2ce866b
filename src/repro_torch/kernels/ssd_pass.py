"""Mamba2 SSD, the recurrence between chunks, forward and backward: the
CUDA kernels' wrappers.

``ssd_pass_kernel`` launches ``csrc/ssd_pass.cu``'s forward (K3): from K2's
terms and C, the state entering every chunk (h_prev), the final state and y
= y_intra + decay_all C h_prev^T in x's type.  ``ssd_pass_bwd_kernel``
launches its backward (K3b).  K3 replaces no TPU kernel: the reference
scans the chunks with ``lax.scan``; here the scan was a Python loop of
PyTorch ops, differentiated by autograd.  Both take CUDA tensors only and
raise on anything their kernels do not take; ``ref.ssd_pass_plain`` and
``ref.ssd_pass_bwd_plain`` are the same functions in plain PyTorch, and
``ops.ssd_pass`` and ``ops.ssd_pass_grads`` choose between them by the
tensors' device.

``ssd_pass_kernel.launches`` and ``ssd_pass_bwd_kernel.launches`` count the
calls: K3's call is two CUDA launches (the walk over the chunks, then the
chunks' outputs), K3b's three (the chunks' gradients, dC summed over heads,
the reverse walk).

Two routes, chosen by :func:`pass_route` from the inputs alone: ``"mma"``
(``mma.sync`` on the tensor cores, each f32 operand split in three bf16
parts) for bf16 at P = 64 or 128 and N a multiple of 8 up to 128, the
models' widths; ``"f32"`` (the CUDA cores) for every other shape or type.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ssd import _DTYPE_CODE

MAX_STATE = 32768       # P * N the walks over the chunks take
_ROUTE_CODE = {"f32": 0, "mma": 1}


def pass_route(C_, P: int) -> str:
    """The route K3 and K3b take for C_ (B,S,N) at head dim P (the rule in
    the module's note; the CUDA source checks the same rule)."""
    N = C_.shape[-1]
    if C_.dtype == torch.bfloat16 and P in (64, 128) and N % 8 == 0 \
            and N <= 128:
        return "mma"
    return "f32"


@functools.cache
def _bind():
    lib = _build.load("ssd_pass")
    fwd, bwd = lib.ssd_pass_fwd, lib.ssd_pass_bwd
    fwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                    + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    bwd.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 8
                    + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    fwd.restype = bwd.restype = ctypes.c_int
    return lib, fwd, bwd


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(what, C_, dtype, named):
    """Each of ``named`` ((name, tensor, shape, dtype)) on C_'s CUDA device,
    contiguous, of its shape and type and 8-byte aligned; C_ of ``dtype``
    (f32 or bf16) with unit stride along N."""
    if C_.device.type != "cuda":
        raise ValueError(f"{what}: C_ is on {C_.device}, the kernel takes "
                         "CUDA tensors")
    if dtype not in _DTYPE_CODE or C_.dtype != dtype:
        raise ValueError(f"{what}: C_ and the output must be both float32 or "
                         f"both bfloat16, got {C_.dtype} and {dtype}")
    if C_.dim() != 3 or C_.stride(2) != 1:
        raise ValueError(f"{what}: C_ must be (B,S,N) with unit stride "
                         f"along N, got {tuple(C_.shape)} {C_.stride()}")
    for name, t, shape, dt in named:
        if t is None:
            continue
        if t.device != C_.device:
            raise ValueError(f"{what}: {name} is on {t.device}, C_ on "
                             f"{C_.device}")
        if tuple(t.shape) != shape or t.dtype != dt \
                or not t.is_contiguous() or t.data_ptr() % 8:
            raise ValueError(f"{what}: {name} must be contiguous, aligned "
                             f"{dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def _dims(what, y_like, states_like, C_):
    Bsz, S, H, P = y_like.shape
    nc, N = states_like.shape[2], states_like.shape[-1]
    if nc <= 0 or S % nc or C_.shape != (Bsz, S, N):
        raise ValueError(f"{what}: shapes {tuple(y_like.shape)}, "
                         f"{tuple(states_like.shape)}, C_ "
                         f"{tuple(C_.shape)} disagree")
    if P * N > MAX_STATE:
        raise ValueError(f"{what}: state {P}x{N} > {MAX_STATE} elements")
    return Bsz, S, H, P, N, S // nc, nc


def ssd_pass_kernel(y_intra, states, decay_all, decay_chunk, C_, h0=None, *,
                    dtype):
    """The CUDA forward, K3: same contract as ``ref.ssd_pass_plain``, (y in
    ``dtype``, hT, h_prev f32).

    y_intra, states, decay_all, decay_chunk as K2 writes them (contiguous
    f32); C_ read in place through its strides; h0 contiguous f32 or None.
    Launches on the current stream and does not synchronise.
    """
    what = "ssd_pass_kernel"
    Bsz, S, H, P, N, Q, nc = _dims(what, y_intra, states, C_)
    f32 = torch.float32
    _check(what, C_, dtype, (
        ("y_intra", y_intra, (Bsz, S, H, P), f32),
        ("states", states, (Bsz, H, nc, P, N), f32),
        ("decay_all", decay_all, (Bsz, H, nc, Q), f32),
        ("decay_chunk", decay_chunk, (Bsz, H, nc), f32),
        ("h0", h0, (Bsz, H, P, N), f32)))
    lib, fwd, _ = _bind()
    y = torch.empty((Bsz, S, H, P), dtype=dtype, device=C_.device)
    hT = torch.empty((Bsz, H, P, N), dtype=f32, device=C_.device)
    h_prev = torch.empty_like(states)
    with torch.cuda.device(C_.device):
        stream = torch.cuda.current_stream(C_.device).cuda_stream
        err = fwd(y_intra.data_ptr(), states.data_ptr(), decay_all.data_ptr(),
                  decay_chunk.data_ptr(), C_.data_ptr(), _ptr(h0),
                  y.data_ptr(), hT.data_ptr(), h_prev.data_ptr(),
                  Bsz, S, H, P, N, Q, _DTYPE_CODE[dtype],
                  _ROUTE_CODE[pass_route(C_, P)], C_.stride(0), C_.stride(1),
                  stream)
    _build.check(lib, err, f"{what} launch")
    _build.count_launch(ssd_pass_kernel)
    return y, hT, h_prev


ssd_pass_kernel.launches = 0


def ssd_pass_bwd_kernel(dy, dhT, h_prev, decay_all, decay_chunk, C_, *,
                        with_dh0: bool):
    """The CUDA backward, K3b: same contract as ``ref.ssd_pass_bwd_plain``,
    (d y_intra, d states, d decay_all, d decay_chunk, dC, dh0), all f32;
    dh0 None unless ``with_dh0``.

    dy contiguous in C_'s type; dhT contiguous f32 or None (zeros); the
    rest as K3 takes and writes them.  Deterministic: no atomics, every sum
    in a fixed order.  Launches on the current stream and does not
    synchronise.
    """
    what = "ssd_pass_bwd_kernel"
    Bsz, S, H, P, N, Q, nc = _dims(what, dy, h_prev, C_)
    f32 = torch.float32
    _check(what, C_, dy.dtype, (
        ("dy", dy, (Bsz, S, H, P), C_.dtype),
        ("dhT", dhT, (Bsz, H, P, N), f32),
        ("h_prev", h_prev, (Bsz, H, nc, P, N), f32),
        ("decay_all", decay_all, (Bsz, H, nc, Q), f32),
        ("decay_chunk", decay_chunk, (Bsz, H, nc), f32)))
    lib, _, bwd = _bind()
    dyi = torch.empty((Bsz, S, H, P), dtype=f32, device=C_.device)
    dstates = torch.empty_like(h_prev)
    ddall = torch.empty_like(decay_all)
    ddchunk = torch.empty_like(decay_chunk)
    dC = torch.empty((Bsz, S, N), dtype=f32, device=C_.device)
    dh0 = (torch.empty((Bsz, H, P, N), dtype=f32, device=C_.device)
           if with_dh0 else None)
    work = torch.empty_like(h_prev)     # X, each chunk's share of d h_prev
    with torch.cuda.device(C_.device):
        stream = torch.cuda.current_stream(C_.device).cuda_stream
        err = bwd(dy.data_ptr(), _ptr(dhT), h_prev.data_ptr(),
                  decay_all.data_ptr(), decay_chunk.data_ptr(), C_.data_ptr(),
                  dyi.data_ptr(), dstates.data_ptr(), ddall.data_ptr(),
                  ddchunk.data_ptr(), dC.data_ptr(), _ptr(dh0),
                  work.data_ptr(), Bsz, S, H, P, N, Q, _DTYPE_CODE[C_.dtype],
                  _ROUTE_CODE[pass_route(C_, P)], C_.stride(0), C_.stride(1),
                  stream)
    _build.check(lib, err, f"{what} launch")
    _build.count_launch(ssd_pass_bwd_kernel)
    return dyi, dstates, ddall, ddchunk, dC, dh0


ssd_pass_bwd_kernel.launches = 0

__all__ = ["ssd_pass_kernel", "ssd_pass_bwd_kernel", "pass_route",
           "MAX_STATE"]
