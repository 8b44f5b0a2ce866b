"""MusicGen-Large — 48L d_model=2048 32H (kv=32, i.e. MHA) d_ff=8192,
vocab 2048 (EnCodec codebook); decoder-only over EnCodec tokens; the EnCodec
frontend is a STUB (tokens arrive precomputed). [arXiv:2306.05284; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    gated_mlp=False,         # musicgen uses a plain 2-matrix FFN
    frontend="audio_stub",
    frontend_tokens=0,       # EnCodec tokens ARE the input stream
    rope_theta=10_000.0,
    source="arXiv:2306.05284",
)
