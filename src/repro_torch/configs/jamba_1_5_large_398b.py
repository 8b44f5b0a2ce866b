"""Jamba-1.5-Large-398B — 72L d_model=8192 64H (GQA kv=8) d_ff=24576,
vocab 65536; Mamba2+attn 1:7 interleave, MoE 16e top-2 every other layer.
[arXiv:2403.19887; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    num_experts_per_tok=2,
    moe_every=2,
    attn_every=8,            # 1 attention layer per 8 (1:7 mamba:attn)
    ssm_state=128,
    d_inner=16384,           # 2 * d_model
    ssm_head_dim=128,
    rope_theta=10_000.0,
    source="arXiv:2403.19887",
)
