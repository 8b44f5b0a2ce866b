"""Flash attention, forward and backward: the CUDA kernels' wrappers and
their plain versions.

``flash_attention_fwd`` launches ``csrc/flash_attention_fwd.cu`` (K1, CUDA
C++ for Hopper, ``sm_90a``), the port of the Pallas TPU kernel
``repro.kernels.flash_attention._kernel``; with ``with_lse`` it also writes
each row's log-sum-exp, which the backward needs.  ``flash_attention_bwd``
launches ``csrc/flash_attention_bwd.cu`` (K1b), the gradients of K1, the
counterpart of the reference's jnp VJP ``_flash_bwd``.  Both take CUDA
tensors only and raise on anything their kernel does not take;
``flash_attention_plain``, ``flash_attention_lse_plain`` and
``flash_attention_bwd_plain`` are the same functions in plain PyTorch.
``ops`` chooses between them by the tensors' device.

``flash_attention_fwd.launches`` and ``flash_attention_bwd.launches`` count
the calls that launch each kernel (K1b's call is three CUDA launches: the
row sums delta, dk/dv, dq).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import (flash_attention_bwd_plain, flash_attention_lse_plain,
                  flash_attention_plain)

HEAD_DIMS = (16, 32, 64, 128, 256)
TMA_HEAD_DIMS = (64, 128)       # K1b's bf16 wgmma path, which reads by TMA
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _bind():
    lib = _build.load("flash_attention_fwd")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _bind_bwd():
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _check_tensors(what, named):
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}, the kernel "
                             "takes CUDA tensors")
        if t.dim() != 4:
            raise ValueError(f"{what}: {name} must be (B, S, H, D), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        if t.numel() == 0:
            raise ValueError(f"{what}: {name} is empty")


def _check_inputs(q, k, v, what="flash_attention_fwd"):
    _check_tensors(what, (("q", q), ("k", k), ("v", v)))
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: q, k, v must all be float32 or all "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{what}: q, k, v on different devices")
    B, _, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if Hq % k.shape[2]:
        raise ValueError(f"{what}: Hq={Hq} is not a multiple of "
                         f"Hkv={k.shape[2]}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D} not in {HEAD_DIMS}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        attn_softcap: float = 0.0, with_lse: bool = False):
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> o (B, Sq, Hq, D) in q's type,
    or (o, lse) with ``with_lse``: lse f32 (B, Sq, Hq), natural log.

    Launches on the current stream and does not synchronise.
    """
    _check_inputs(q, k, v)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    lib, fn = _bind()
    o = torch.empty_like(q)
    lse = (torch.empty((B, Sq, Hq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr() if with_lse else None,
                 B, Sq, Skv, Hq, Hkv, D, _DTYPE_CODE[q.dtype], int(causal),
                 int(window), float(attn_softcap), float(D ** -0.5),
                 _stream(q.device))
    _build.check(lib, err, "flash_attention_fwd launch")
    _build.count_launch(flash_attention_fwd)
    return (o, lse) if with_lse else o


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, attn_softcap: float = 0.0):
    """Gradients of :func:`flash_attention_fwd`: (dq, dk, dv) in the inputs'
    type from q, o, do (B, Sq, Hq, D), k, v (B, Skv, Hkv, D) and the
    forward's lse, f32 (B, Sq, Hq).  Deterministic: the same inputs give
    bitwise the same gradients.  In bf16 at head dim 64 or 128 the kernel
    reads q, k, v, o and do in 16-byte pieces (TMA and vector loads): a
    view that starts at an address that is not 16-byte aligned raises
    ValueError.

    Launches on the current stream and does not synchronise.
    """
    what = "flash_attention_bwd"
    _check_inputs(q, k, v, what)
    _check_tensors(what, (("o", o), ("do", do)))
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"{what}: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must be q's shape "
                         f"{tuple(q.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"{what}: o and do must be {q.dtype}, got "
                         f"{o.dtype}, {do.dtype}")
    B, Sq, Hq, D = q.shape
    if (lse.dtype != torch.float32 or lse.shape != (B, Sq, Hq)
            or not lse.is_contiguous()):
        raise ValueError(f"{what}: lse must be contiguous float32 "
                         f"{(B, Sq, Hq)}, got {lse.dtype} {tuple(lse.shape)}")
    if not all(t.device == q.device for t in (o, do, lse)):
        raise ValueError(f"{what}: inputs on different devices")
    if q.dtype == torch.bfloat16 and D in TMA_HEAD_DIMS:
        for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
            if t.data_ptr() % 16:
                raise ValueError(f"{what}: {name} starts at an address that is "
                                 "not 16-byte aligned; the bf16 kernel reads "
                                 f"it in 16-byte pieces at head dim {D}")
    Skv, Hkv = k.shape[1], k.shape[2]
    lib, fn = _bind_bwd()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # scratch: delta and lse in log2 units, each (B, Hq, Sq rounded up to 64)
    delta = torch.empty(2 * B * Hq * (-(-Sq // 64) * 64), dtype=torch.float32,
                        device=q.device)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 B, Sq, Skv, Hq, Hkv, D, _DTYPE_CODE[q.dtype], int(causal),
                 int(window), float(attn_softcap), float(D ** -0.5),
                 _stream(q.device))
    _build.check(lib, err, "flash_attention_bwd launch")
    _build.count_launch(flash_attention_bwd)
    return dq, dk, dv


flash_attention_bwd.launches = 0

__all__ = ["flash_attention_fwd", "flash_attention_plain",
           "flash_attention_lse_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "HEAD_DIMS"]
