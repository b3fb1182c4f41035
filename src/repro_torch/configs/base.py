"""Config system: model / shape / train / quant configs.

A copy of the JAX package's ``configs/base.py`` (that module imports no JAX,
but the port keeps its own copy so it never imports the JAX package). Every
architecture of the reference is a ``ModelConfig`` in its own module under
``repro_torch.configs``; ``get_config(name)`` resolves by id (e.g.
"qwen2-1.5b").
``reduced(cfg)`` shrinks any config to a CPU-smokeable size with the same
family-specific structure.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "TrainConfig", "get_config",
           "reduced", "LM_SHAPES", "ARCH_IDS", "shape_by_name"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    vocab_size: int
    # attention (0 heads => attention-free)
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int = 0         # 0 => full attention
    rope_theta: float = 10000.0
    # ffn
    d_ff: int = 0
    mlp_act: str = "silu"           # silu (SwiGLU) | gelu | sigmoid
    # moe
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_bf16: bool = False          # SSD einsum operands in bf16 (§Perf)
    ssm_split_proj: bool = False    # shard-aligned split z/x/BC/dt projections
                                    # + per-component convs (§Perf H-split)
    # hybrid (zamba2-style shared attention)
    attn_every: int = 0             # 0 => not hybrid
    # frontend stub
    frontend: Optional[str] = None  # audio | vision
    frontend_tokens: int = 256      # patches/frames provided pre-embedded
    # numerics
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    @property
    def attention_free(self) -> bool:
        return self.num_heads == 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / sliding-window)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        n = v * d * (1 if self.tie_embeddings else 2)            # embed + head
        per_layer = 0
        if self.num_heads:
            hd = self.head_dim or d // self.num_heads
            per_layer += d * self.num_heads * hd                  # wq
            per_layer += 2 * d * self.num_kv_heads * hd           # wk, wv
            per_layer += self.num_heads * hd * d                  # wo
        if self.family in ("ssm", "hybrid"):
            di, ns = self.d_inner, self.ssm_state
            in_dim = 2 * di + 2 * self.ssm_ngroups * ns + self.ssm_heads
            per_layer_ssm = d * in_dim + di * d                   # in/out proj
            per_layer_ssm += self.ssm_conv * (di + 2 * self.ssm_ngroups * ns)
            if self.family == "ssm":
                per_layer = per_layer_ssm
            else:
                # hybrid: every layer is ssm; ONE shared attn block extra
                n += per_layer + 3 * d * ff if False else 0
                per_layer = per_layer_ssm
        if ff and self.family not in ("moe", "hybrid"):
            # hybrid layers are pure mamba blocks — only the ONE shared
            # attention block has an FFN (added below)
            nmats = 3 if self.mlp_act == "silu" else 2
            per_layer += nmats * d * ff
        if self.family == "moe":
            nmats = 3 if self.mlp_act == "silu" else 2
            per_layer += self.num_experts * nmats * d * ff
            per_layer += d * self.num_experts                     # router
        n += self.num_layers * per_layer
        if self.family == "hybrid" and self.num_heads:
            hd = self.head_dim or d // self.num_heads
            n += 2 * (d * self.num_heads * hd) + 2 * d * self.num_kv_heads * hd
            n += 3 * d * ff if ff else 0                          # shared block
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        nmats = 3 if self.mlp_act == "silu" else 2
        inactive = self.num_layers * (self.num_experts - self.experts_per_token) * nmats * d * ff
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3
    momentum: float = 0.9            # paper: SGD momentum 0.9
    optimizer: str = "adamw"         # adamw | sgd (paper)
    weight_decay: float = 0.0
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    microbatches: int = 1            # grad accumulation
    remat: str = "layer"             # none | layer | full
    seed: int = 0


ARCH_IDS = (
    "musicgen-large", "qwen3-32b", "qwen2.5-14b", "stablelm-3b", "qwen2-1.5b",
    "phi3.5-moe-42b-a6.6b", "mixtral-8x22b", "mamba2-2.7b", "internvl2-26b",
    "zamba2-1.2b",
)

_MODULE_FOR = {
    "qwen2-1.5b": "qwen2_1_5b",
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen3-32b": "qwen3_32b",
    "stablelm-3b": "stablelm_3b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "mixtral-8x22b": "mixtral_8x22b",
    "mamba2-2.7b": "mamba2_2_7b",
    "zamba2-1.2b": "zamba2_1_2b",
    "musicgen-large": "musicgen_large",
    "internvl2-26b": "internvl2_26b",
    "digit": "digit",
    "phoneme": "phoneme",
}


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[name]}")
    return mod.CONFIG


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
            vocab: int = 128) -> ModelConfig:
    """Shrink to CPU-smokeable size, preserving family structure."""
    scale = d_model / cfg.d_model
    heads = max(1, min(cfg.num_heads, 4)) if cfg.num_heads else 0
    kv = max(1, min(cfg.num_kv_heads, heads)) if cfg.num_kv_heads else 0
    return dataclasses.replace(
        cfg,
        num_layers=layers,
        d_model=d_model,
        d_ff=max(16, int(cfg.d_ff * scale)) if cfg.d_ff else 0,
        vocab_size=vocab,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=d_model // heads if heads else 0,
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.experts_per_token else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.ssm_state else 64,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
        attn_every=2 if cfg.attn_every else 0,
        frontend_tokens=8 if cfg.frontend else cfg.frontend_tokens,
    )
