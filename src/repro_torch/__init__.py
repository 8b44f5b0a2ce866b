"""PyTorch/CUDA port of the model workloads of ``repro``.

The JAX package ``repro`` is the reference; this package computes the same
functions in PyTorch and replaces its Pallas TPU kernels with CUDA kernels
written for Hopper (``repro_torch.kernels``).  It imports ``torch`` and
never ``jax`` or anything of ``repro``.

Entry points run on ``cuda`` unless the caller asks for ``"cpu"``; see
:func:`resolve_device`.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
