"""Public wrapper of the fused decode attention.

Takes the model-side decode shapes (q (B, 1, H, D) against a (B, S, KV, D)
cache, scalar or per-row ``cache_len``, optional (B, S) int8-cache scales)
and dispatches on the tensor's device: a CPU tensor runs the plain version
(``ref.attn_decode_ref``), a CUDA tensor the hand-written kernel after the
GQA reshape, with the 1/sqrt(D) scale rounded to q's dtype on the host
(the kernel multiplies q by it in q's dtype as it stages q); the kernel
raises rather than fall back.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.attn_decode import kernel, ref

__all__ = ["attn_decode", "prescale_q"]


def prescale_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """``ref.scale_q`` with its scalar rounded to q's dtype on the host: the
    same product, without copying a scalar tensor to the card, which would
    be a blocking copy and so synchronise the stream on every call."""
    return q * torch.tensor(scale, dtype=q.dtype).item()


@functools.lru_cache(maxsize=None)
def _q_scale(d: int, dtype: torch.dtype) -> float:
    """1/sqrt(D) rounded to ``dtype``, as ``ref.scale_q`` rounds it."""
    return torch.tensor(1.0 / (d ** 0.5), dtype=dtype).item()


def attn_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                cache_len, k_scale: torch.Tensor | None = None,
                v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Fused one-token GQA attention: q (B, 1, H, D) x cache (B, S, KV, D)
    -> (B, 1, H, D) in q's dtype."""
    if q.device.type == "cpu":
        return ref.attn_decode_ref(q, k_cache, v_cache, cache_len,
                                   k_scale, v_scale)
    if not q.is_cuda:
        raise ValueError(f"attn_decode: no path for device {q.device}")
    b, _, h, d = q.shape
    kv = k_cache.shape[2]
    q4 = q.reshape(b, kv, h // kv, d).contiguous()
    lens = torch.as_tensor(cache_len, device=q.device).to(torch.int32)
    lens = lens.reshape(-1).expand(b).contiguous()
    out = kernel.attn_decode_cuda(q4, k_cache, v_cache, lens, k_scale, v_scale,
                                  q_scale=_q_scale(d, q.dtype))
    return out.reshape(b, 1, h, d)
