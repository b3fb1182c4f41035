"""Public wrapper of the blocked prefill attention.

Plain (B, T, H, D) queries in; the GQA grouping, the 1/sqrt(D) pre-scale
in q's dtype and the visibility-bound plumbing are done here. Dispatches on
the tensor's device: a CPU tensor runs the plain version
(``ref.attn_prefill_ref``), a CUDA tensor the hand-written kernel, which
raises rather than fall back. Bucketed prefill passes
``hi = min(t + 1, lengths[row])``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attn_decode.ops import prescale_q
from repro_torch.kernels.attn_prefill import kernel, ref

__all__ = ["attn_prefill"]


def attn_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, hi,
                 lo=None, k_scale: torch.Tensor | None = None,
                 v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """q (B, T, H, D) against k/v (B, S, KV, D) (fp or int8 + per-token
    (B, S) scales); query ``t`` of row ``b`` sees key positions
    ``lo[b, t] <= p < hi[b, t]`` (``lo`` defaults to 0). Returns
    (B, T, H, D) in q's dtype."""
    b, t, h, d = q.shape
    kv = k.shape[2]
    qg = prescale_q(q, d ** -0.5).reshape(b, t, kv, h // kv, d)
    hi = torch.as_tensor(hi, device=q.device).to(torch.int32).expand(b, t)
    if lo is not None:
        lo = torch.as_tensor(lo, device=q.device).to(torch.int32).expand(b, t)
    if q.device.type == "cpu":
        if lo is None:
            lo = torch.zeros((b, t), dtype=torch.int32)
        out = ref.attn_prefill_ref(qg, k, v, lo, hi, k_scale, v_scale)
    elif q.is_cuda:                      # the kernels read lo = None as 0
        out = kernel.attn_prefill_cuda(qg.contiguous(), k, v,
                                       None if lo is None else lo.contiguous(),
                                       hi.contiguous(), k_scale, v_scale)
    else:
        raise ValueError(f"attn_prefill: no path for device {q.device}")
    return out.reshape(b, t, h, d)
