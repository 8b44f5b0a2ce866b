"""Gemma2-9B — 42L d_model=3584 16H (GQA kv=8) d_ff=14336, vocab 256000;
local(4096-window)+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,           # gemma2 uses head_dim 256 (16*256 = 4096 != d_model)
    d_ff=14336,
    vocab_size=256000,
    sliding_window=4096,
    local_global_alternate=True,
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
    rope_theta=10_000.0,
    source="arXiv:2408.00118",
)
