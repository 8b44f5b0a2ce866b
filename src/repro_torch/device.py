"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    ``None`` means ``cuda``.  A CUDA device without a usable card raises:
    nothing falls back to the CPU unless the caller asked for the CPU.
    ``meta`` (shapes and dtypes without storage) serves the dry-run.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "the port on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def torch_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """``"bfloat16"`` (a config's dtype name) or a torch dtype -> torch dtype."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)
