"""Model / shape configuration system.

Every assigned architecture is expressed as a :class:`ModelConfig`; the
workflow runtime treats each (config, shape) pair as a *task species* — the
paper's "heterogeneous tasks" — so configs carry everything the task
translator needs to derive resource requirements (parameter bytes, FLOPs per
token) in addition to what the model builder needs.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | vlm | audio | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_every: int = 1               # MoE FFN every k-th layer (jamba: 2)
    capacity_factor: float = 1.25
    moe_dispatch: str = "einsum"     # einsum (GShard-style) | gather (zero-FLOP)

    # --- attention variants ---
    sliding_window: int = 0          # window size for local layers (gemma2: 4096)
    local_global_alternate: bool = False
    attn_softcap: float = 0.0        # gemma2: 50.0
    logit_softcap: float = 0.0       # gemma2: 30.0
    rope_theta: float = 10_000.0

    # --- SSM / hybrid ---
    ssm_state: int = 0               # N (mamba2 d_state)
    d_inner: int = 0                 # mamba inner width (default 2*d_model)
    ssm_head_dim: int = 64           # P
    ssm_chunk: int = 256             # SSD chunk length
    conv_width: int = 4
    attn_every: int = 0              # hybrid: 1 attention layer per `attn_every` (jamba: 8)

    # --- frontend stubs ---
    frontend: str = "none"           # none | vision_stub | audio_stub
    frontend_tokens: int = 0         # patch/frame positions occupied by the stub

    # --- misc ---
    tie_embeddings: bool = False
    gated_mlp: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # remat policy: "full" | "dots" | "none"  (hillclimb knob)
    remat: str = "full"
    source: str = ""

    # ------------------------------------------------------------------ #
    @property
    def ssm_heads(self) -> int:
        inner = self.d_inner or 2 * self.d_model
        return inner // self.ssm_head_dim

    @property
    def inner_dim(self) -> int:
        return self.d_inner or 2 * self.d_model

    def layer_kind(self, i: int) -> str:
        """Mixer kind for layer i: 'attn' | 'local_attn' | 'mamba'."""
        if self.family == "ssm":
            return "mamba"
        if self.attn_every:  # hybrid (jamba): one attn per attn_every layers
            return "attn" if (i % self.attn_every) == (self.attn_every - 1) else "mamba"
        if self.local_global_alternate:
            return "local_attn" if i % 2 == 0 else "attn"
        return "attn"

    def ffn_kind(self, i: int) -> str:
        """FFN kind for layer i: 'dense' | 'moe' | 'none'."""
        if self.d_ff == 0 and self.num_experts == 0:
            return "none"
        if self.num_experts and (i % self.moe_every) == (self.moe_every - 1):
            return "moe"
        if self.d_ff:
            return "dense"
        return "none"

    # ----------------------- analytic accounting ---------------------- #
    def param_count(self) -> int:
        """Analytic parameter count (matches init within rounding)."""
        d, hd = self.d_model, self.head_dim
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for i in range(self.num_layers):
            kind = self.layer_kind(i)
            if kind in ("attn", "local_attn"):
                n += d * self.num_heads * hd            # wq
                n += 2 * d * self.num_kv_heads * hd     # wk, wv
                n += self.num_heads * hd * d            # wo
            else:  # mamba2
                inner, nh, N = self.inner_dim, self.ssm_heads, self.ssm_state
                n += d * (2 * inner + 2 * N + nh)       # in_proj (x,z,B,C,dt)
                n += inner * d                          # out_proj
                n += self.conv_width * (inner + 2 * N)  # conv
                n += 3 * nh                             # A_log, D, dt_bias
            fk = self.ffn_kind(i)
            mats = 3 if self.gated_mlp else 2
            if fk == "dense":
                n += mats * d * self.d_ff
            elif fk == "moe":
                n += d * self.num_experts               # router
                n += self.num_experts * mats * d * self.d_ff
            n += d + (d if fk != "none" else 0)         # pre-mixer (+pre-ffn) norms
        n += d                                          # final norm
        if self.frontend == "vision_stub":
            n += 2 * d * d                              # connector MLP
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        mats = 3 if self.gated_mlp else 2
        n = self.param_count()
        n_moe_layers = sum(1 for i in range(self.num_layers) if self.ffn_kind(i) == "moe")
        inactive = n_moe_layers * (self.num_experts - self.num_experts_per_tok) * mats * d * self.d_ff
        return n - inactive

    def model_flops_per_token(self, training: bool) -> float:
        """6*N_active per token (bwd = 2x fwd) or 2*N_active for inference."""
        return (6.0 if training else 2.0) * self.active_param_count()


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def tokens(self) -> int:
        # decode processes 1 new token per sequence against a seq_len cache
        return self.global_batch * (1 if self.kind == "decode" else self.seq_len)


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# Archs with a sub-quadratic mechanism run long_500k; pure full-attention
# archs skip it (recorded in DESIGN.md §Arch-applicability).
LONG_CONTEXT_OK = {"gemma2-9b", "jamba-1.5-large-398b", "mamba2-1.3b"}


def cells(arch: str) -> list:
    """The dry-run cells for one architecture."""
    out = []
    for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        if s == "long_500k" and arch not in LONG_CONTEXT_OK:
            out.append((s, "SKIP(full-attn)"))
        else:
            out.append((s, "RUN"))
    return out


def reduce_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    small = dict(
        num_layers=max(2, cfg.attn_every or 0, 2 * (cfg.moe_every or 1)),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 2,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=257,
        num_experts=4 if cfg.num_experts else 0,
        num_experts_per_tok=2 if cfg.num_experts else 0,
        d_inner=128 if (cfg.family in ("ssm", "hybrid")) else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=32,
        ssm_chunk=8,
        sliding_window=8 if cfg.sliding_window else 0,
        frontend_tokens=4 if cfg.frontend != "none" else 0,
        name=cfg.name + "-smoke",
    )
    if cfg.attn_every:
        small["num_layers"] = 2 * cfg.attn_every  # cover both mixer kinds
    small.update(overrides)
    return replace(cfg, **small)
