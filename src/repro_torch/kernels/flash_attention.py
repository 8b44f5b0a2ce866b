"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

``flash_attention_fwd`` launches ``csrc/flash_attention_fwd.cu`` (CUDA C++
for Hopper, ``sm_90a``), the port of the Pallas TPU kernel
``repro.kernels.flash_attention._kernel``.  It takes CUDA tensors only and
raises on anything the kernel does not take; ``flash_attention_plain`` is
the same function in plain PyTorch.  ``ops.flash_attention`` chooses
between them by the tensors' device.

``flash_attention_fwd.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import attention_reference as flash_attention_plain

HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _bind():
    lib = _build.load("flash_attention_fwd")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _check_inputs(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_fwd: {name} is on {t.device}, "
                             "the kernel takes CUDA tensors")
        if t.dim() != 4:
            raise ValueError(f"flash_attention_fwd: {name} must be "
                             f"(B, S, H, D), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_fwd: {name} is not contiguous")
        if t.numel() == 0:
            raise ValueError(f"flash_attention_fwd: {name} is empty")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise ValueError("flash_attention_fwd: q, k, v must all be float32 "
                         f"or all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention_fwd: q, k, v on different devices")
    B, _, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention_fwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if Hq % k.shape[2]:
        raise ValueError(f"flash_attention_fwd: Hq={Hq} is not a multiple of "
                         f"Hkv={k.shape[2]}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dim {D} not in {HEAD_DIMS}")


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        attn_softcap: float = 0.0):
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> o (B, Sq, Hq, D) in q's type.

    Launches on the current stream and does not synchronise.
    """
    _check_inputs(q, k, v)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    lib, fn = _bind()
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, Sq, Skv, Hq, Hkv, D, _DTYPE_CODE[q.dtype], int(causal),
                 int(window), float(attn_softcap), float(D ** -0.5), stream)
    _build.check(lib, err, "flash_attention_fwd launch")
    flash_attention_fwd.launches += 1
    return o


flash_attention_fwd.launches = 0

__all__ = ["flash_attention_fwd", "flash_attention_plain", "HEAD_DIMS"]
