"""CUDA launch wrapper of the fused decode attention (``csrc/attn_decode.cu``).

``launches`` counts launches; nothing else touches it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["attn_decode_cuda", "check_kv", "launches"]

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def check_kv(q, k, v, k_scale, v_scale, kv_shape, what: str) -> bool:
    """Shared checks of the attention kernels: q fp32/bf16, head_dim in
    32/64/128/256, a group of at most 32 heads per KV head, K/V of
    ``kv_shape`` in q's dtype — or int8 with (B, S) fp32 scales, both or
    neither. Returns whether the cache is int8."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} q: need fp32/bf16, got {q.dtype}")
    g, d = q.shape[-2], q.shape[-1]
    if d not in (32, 64, 128, 256) or g * 32 > 1024:
        raise ValueError(f"{what}: head_dim {d} / group {g} not supported "
                         f"(D in 32/64/128/256, G <= 32)")
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{what}: pass both k_scale and v_scale, or neither")
    quantized = k_scale is not None
    kv_types = (torch.int8,) if quantized else (q.dtype,)
    _build.require(k, kv_shape, kv_types, q.device, f"{what} k")
    _build.require(v, kv_shape, kv_types, q.device, f"{what} v")
    if quantized:
        sshape = kv_shape[:2]
        _build.require(k_scale, sshape, (torch.float32,), q.device,
                       f"{what} k_scale")
        _build.require(v_scale, sshape, (torch.float32,), q.device,
                       f"{what} v_scale")
    return quantized


def attn_decode_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """q (B, KV, G, D) fp32/bf16 pre-scaled by 1/sqrt(D); k/v cache
    (B, S, KV, D) in q's dtype, or int8 with (B, S) fp32 scales; cache_len
    (B,) int32 -> (B, KV, G, D) in q's dtype."""
    global launches
    if not q.is_cuda or q.dim() != 4 or not q.is_contiguous():
        raise ValueError(f"attn_decode q: need a contiguous (B, KV, G, D) "
                         f"CUDA tensor, got {tuple(q.shape)} on {q.device}")
    b, kv, g, d = q.shape
    s = k_cache.shape[1]
    quantized = check_kv(q, k_cache, v_cache, k_scale, v_scale,
                         (b, s, kv, d), "attn_decode")
    _build.require(cache_len, (b,), (torch.int32,), q.device,
                   "attn_decode cache_len")
    out = torch.empty_like(q)
    if b * kv == 0:
        return out
    with torch.cuda.device(q.device):
        rc = _build.function("attn_decode", _ARGTYPES)(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            cache_len.data_ptr(), out.data_ptr(), b, s, kv, g, d,
            _build.dtype_code(q.dtype), _build.dtype_code(k_cache.dtype),
            _build.stream_ptr(q.device))
    _build.check(rc, "attn_decode")
    launches += 1
    return out
