"""DBRX-132B — 40L d_model=6144 48H (GQA kv=8) d_ff=10752, vocab 100352,
MoE 16 experts top-4 (fine-grained).  [hf:databricks/dbrx-base; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    num_experts_per_tok=4,
    rope_theta=5e5,
    source="hf:databricks/dbrx-base",
)
