"""Mamba2-1.3B — 48L d_model=2048, attention-free SSD, ssm_state=128,
vocab 50280.  [arXiv:2405.21060; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,                  # pure mamba block, no separate FFN
    vocab_size=50280,
    ssm_state=128,
    d_inner=4096,
    ssm_head_dim=64,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
