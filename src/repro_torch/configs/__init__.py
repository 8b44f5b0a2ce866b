"""Architecture registry: one module per assigned architecture.

A copy of ``repro.configs`` (pure data), kept in the port so that
``repro_torch`` imports nothing of the JAX package; the tests hold every
field equal to the reference's.
"""
from __future__ import annotations

import importlib

from .base import (LONG_CONTEXT_OK, SHAPES, ModelConfig, ShapeConfig, cells,
                   reduce_config)

ARCHS = [
    "qwen3-moe-235b-a22b",
    "dbrx-132b",
    "gemma2-9b",
    "internlm2-1.8b",
    "granite-3-2b",
    "smollm-360m",
    "jamba-1.5-large-398b",
    "internvl2-76b",
    "musicgen-large",
    "mamba2-1.3b",
]

_MODULE = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "dbrx-132b": "dbrx_132b",
    "gemma2-9b": "gemma2_9b",
    "internlm2-1.8b": "internlm2_1_8b",
    "granite-3-2b": "granite_3_2b",
    "smollm-360m": "smollm_360m",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "internvl2-76b": "internvl2_76b",
    "musicgen-large": "musicgen_large",
    "mamba2-1.3b": "mamba2_1_3b",
}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULE:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULE)}")
    mod = importlib.import_module(f"{__name__}.{_MODULE[name]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


__all__ = [
    "ARCHS", "SHAPES", "LONG_CONTEXT_OK", "ModelConfig", "ShapeConfig",
    "get_config", "get_shape", "cells", "reduce_config",
]
