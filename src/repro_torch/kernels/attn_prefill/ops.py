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

from repro_torch.kernels.attn_decode.ops import merge_lse, prescale_q
from repro_torch.kernels.attn_prefill import kernel, ref

__all__ = ["attn_prefill"]


def attn_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, hi,
                 lo=None, k_scale: torch.Tensor | None = None,
                 v_scale: torch.Tensor | None = None, with_lse: bool = False,
                 reduce=None):
    """q (B, T, H, D) against k/v (B, S, KV, D) (fp or int8 + per-token
    (B, S) scales); query ``t`` of row ``b`` sees key positions
    ``lo[b, t] <= p < hi[b, t]`` (``lo`` defaults to 0). Returns
    (B, T, H, D) in q's dtype; with ``with_lse`` also the (B, T, H) fp32
    log-sum-exp of each query's visible scores (-inf where none is).
    ``reduce(t, op)``, where given, all-reduces across the ranks holding
    the rest of a sequence-sharded K/V (``shards.attention_on_shards``):
    the kernel's output and log-sum-exp are merged
    (``attn_decode.ops.merge_lse``); the plain version reduces its softmax
    statistics as it goes."""
    b, t, h, d = q.shape
    kv = k.shape[2]
    qg = prescale_q(q, d ** -0.5).reshape(b, t, kv, h // kv, d)
    hi = torch.as_tensor(hi, device=q.device).to(torch.int32).expand(b, t)
    if lo is not None:
        lo = torch.as_tensor(lo, device=q.device).to(torch.int32).expand(b, t)
    if q.device.type == "cpu":
        if lo is None:
            lo = torch.zeros((b, t), dtype=torch.int32)
        res = ref.attn_prefill_ref(qg, k, v, lo, hi, k_scale, v_scale,
                                   with_lse=with_lse, reduce=reduce)
        if not with_lse:
            return res.reshape(b, t, h, d)
        return res[0].reshape(b, t, h, d), res[1].reshape(b, t, h)
    if not q.is_cuda:
        raise ValueError(f"attn_prefill: no path for device {q.device}")
    # the kernels read lo = None as 0
    want_lse = with_lse or reduce is not None
    res = kernel.attn_prefill_cuda(qg.contiguous(), k, v,
                                   None if lo is None else lo.contiguous(),
                                   hi.contiguous(), k_scale, v_scale,
                                   with_lse=want_lse)
    if not want_lse:
        return res.reshape(b, t, h, d)
    out, lse = res[0].reshape(b, t, h, d), res[1].reshape(b, t, h)
    if reduce is not None:
        out, lse = merge_lse(out, lse, reduce)
    return (out, lse) if with_lse else out
