"""Modality frontend stubs — port of the reference's
``models/frontends.py``: the ``audio`` / ``vlm`` architectures take
precomputed frame / patch embeddings (the EnCodec encoder and the InternViT
tower are out of scope); these helpers give their shape and a synthetic
stand-in. Serving reads tokens only, so ``prefill`` and ``decode_step``
never see them.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["frontend_embed_shape", "synthetic_frontend_embeds", "text_len"]


def frontend_embed_shape(cfg: ModelConfig, batch: int):
    """(B, F, d_model): the precomputed embeddings' shape."""
    return (batch, cfg.frontend_tokens, cfg.d_model)


def text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Token positions left for text when the frontend prefix is included."""
    if cfg.frontend is None:
        return seq_len
    return max(seq_len - cfg.frontend_tokens, 1)


def synthetic_frontend_embeds(gen: torch.Generator, cfg: ModelConfig,
                              batch: int, dtype=torch.bfloat16,
                              device=None) -> torch.Tensor:
    """N(0, 0.02^2) stand-in embeddings from ``gen`` on ``device``."""
    x = torch.randn(frontend_embed_shape(cfg, batch), generator=gen,
                    dtype=torch.float32, device=device)
    return x.mul_(0.02).to(dtype)
