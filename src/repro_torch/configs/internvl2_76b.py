"""InternVL2-76B (LM backbone) — 80L d_model=8192 64H (GQA kv=8) d_ff=28672,
vocab 128256; InternViT frontend is a STUB (input_specs feeds patch
embeddings).  [arXiv:2404.16821; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    frontend="vision_stub",
    frontend_tokens=1024,    # patch-embedding positions inside each sequence
    rope_theta=5e5,
    source="arXiv:2404.16821",
)
