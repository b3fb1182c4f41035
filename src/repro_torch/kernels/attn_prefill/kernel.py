"""CUDA launch wrapper of the blocked prefill attention
(``csrc/attn_prefill.cu``). ``launches`` counts launches; nothing else
touches it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.attn_decode.kernel import check_kv

__all__ = ["attn_prefill_cuda", "launches"]

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def attn_prefill_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lo: torch.Tensor, hi: torch.Tensor,
                      k_scale: torch.Tensor | None = None,
                      v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """q (B, T, KV, G, D) fp32/bf16 pre-scaled by 1/sqrt(D); k/v
    (B, S, KV, D) in q's dtype, or int8 with (B, S) fp32 scales; lo/hi
    (B, T) int32 -> (B, T, KV, G, D) in q's dtype."""
    global launches
    if not q.is_cuda or q.dim() != 5 or not q.is_contiguous():
        raise ValueError(f"attn_prefill q: need a contiguous (B, T, KV, G, D)"
                         f" CUDA tensor, got {tuple(q.shape)} on {q.device}")
    b, t, kv, g, d = q.shape
    s = k.shape[1]
    quantized = check_kv(q, k, v, k_scale, v_scale, (b, s, kv, d),
                         "attn_prefill")
    _build.require(lo, (b, t), (torch.int32,), q.device, "attn_prefill lo")
    _build.require(hi, (b, t), (torch.int32,), q.device, "attn_prefill hi")
    out = torch.empty_like(q)
    if b * t * kv == 0:
        return out
    with torch.cuda.device(q.device):
        rc = _build.function("attn_prefill", _ARGTYPES)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            lo.data_ptr(), hi.data_ptr(), out.data_ptr(),
            b, t, s, kv, g, d, _build.dtype_code(q.dtype),
            _build.dtype_code(k.dtype), _build.stream_ptr(q.device))
    _build.check(rc, "attn_prefill")
    launches += 1
    return out
