"""Unified model interface — port of the reference's ``models/api.py`` for
the families the port serves (dense).

    init(gen, cfg, dtype, device)                        -> params
    prefill(params, batch, cfg, *, policy, ...)          -> (logits, cache)
    decode_step(params, cache, tokens, cfg, *, policy)   -> (logits, cache)
    init_cache(cfg, batch, max_len, ...)                 -> cache
    insert_prefill / insert_prefill_many / free_slots    -> cache (in place)

``matmul_mode="auto"|"kernel"|"dequant"`` and ``attn_mode="auto"|"kernel"|
"ref"`` select the CUDA kernels or their plain versions; 'auto' takes the
kernels for CUDA tensors. ``init_cache(..., kv_bits=8)`` stores the KV
cache as int8 plus per-token fp32 scales.
"""
from __future__ import annotations

from types import ModuleType
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

__all__ = ["get_model", "init_cache", "prefill", "decode_step",
           "insert_prefill", "insert_prefill_many", "free_slots"]

_FAMILY_MODULE = {"dense": transformer}


def get_model(cfg: ModelConfig) -> ModuleType:
    if cfg.family not in _FAMILY_MODULE:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    return _FAMILY_MODULE[cfg.family]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               per_slot_len: bool = False, kv_bits: Optional[int] = None,
               device=None):
    """Decode cache for ``batch`` rows. ``per_slot_len`` makes ``len`` a
    (batch,) int32 vector (the batched engine's layout); ``kv_bits=8``
    allocates int8 K/V plus per-token fp32 scales."""
    if kv_bits not in (None, 8):
        raise ValueError(f"kv_bits must be None or 8, got {kv_bits!r}")
    cache = get_model(cfg).init_cache(cfg, batch, max_len,
                                      dtype or torch.bfloat16,
                                      quantized=kv_bits == 8, device=device)
    if per_slot_len:
        cache["len"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return cache


def prefill(params, batch, cfg: ModelConfig, **kw):
    return get_model(cfg).prefill(params, batch, cfg, **kw)


def decode_step(params, cache, tokens, cfg: ModelConfig, **kw):
    return get_model(cfg).decode_step(params, cache, tokens, cfg, **kw)


def free_slots(cfg: ModelConfig, cache, slots):
    return get_model(cfg).free_slots(cache, slots)


def insert_prefill(cfg: ModelConfig, cache, slot, src):
    return get_model(cfg).insert_prefill(cache, slot, src)


def insert_prefill_many(cfg: ModelConfig, cache, slot_map, src):
    return get_model(cfg).insert_prefill_many(cache, slot_map, src)
