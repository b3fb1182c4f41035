"""Plain PyTorch version of the blocked prefill attention (the reference's
``attn_prefill/ref.py``): the CPU path of ``ops.attn_prefill`` and the
oracle the CUDA kernel is held against.

One dense contraction: fp32 scores, per-query [lo, hi) masking, guarded
softmax (empty windows give zeros), int8 scales factored where the kernel
applies them. ``calls`` counts its uses, and also the model-level reference
prefill path (``models.attention.prefill_attention(mode="ref")``) that
stands in for the kernel.
"""
from __future__ import annotations

import torch

__all__ = ["attn_prefill_ref", "NEG_INF", "calls"]

NEG_INF = -1e30
calls = 0


def attn_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lo, hi, k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None,
                     with_lse: bool = False, reduce=None):
    """q (B, T, KV, G, D) PRE-SCALED by 1/sqrt(D); k/v (B, S, KV, D);
    lo/hi (B, T) int32; optional (B, S) fp32 per-token scales. Returns
    (B, T, KV, G, D) in q's dtype; with ``with_lse`` also the
    (B, T, KV, G) fp32 log-sum-exp of each query's visible scores, m +
    log(l) (-inf for a query with none), as the kernels write it.
    ``reduce(t, op)``, where given, all-reduces the row max, the sum and
    the P . V sums across the ranks that hold the rest of a
    sequence-sharded K/V (``shards.attention_on_shards``), so the ranks
    compute what one process would, to fp32 summation order."""
    global calls
    calls += 1
    b, t = q.shape[:2]
    s = k.shape[1]
    lo = torch.as_tensor(lo, device=q.device).expand(b, t)
    hi = torch.as_tensor(hi, device=q.device).expand(b, t)
    sc = torch.einsum("btkgd,bskd->bkgts", q.float(), k.to(q.dtype).float())
    if k_scale is not None:
        sc = sc * k_scale.float()[:, None, None, None, :]
    pos = torch.arange(s, device=q.device)
    valid = ((pos[None, None, :] < hi[:, :, None])
             & (pos[None, None, :] >= lo[:, :, None]))          # (B, T, S)
    sc = torch.where(valid[:, None, None], sc,
                     torch.tensor(NEG_INF, device=q.device))
    m = sc.amax(dim=-1, keepdim=True)
    if reduce is not None:
        m = reduce(m, "max")
    p = torch.where(m > NEG_INF / 2, torch.exp(sc - m), torch.zeros_like(sc))
    l = p.sum(dim=-1, keepdim=True)
    if reduce is not None:
        l = reduce(l, "sum")
    p = p / torch.clamp(l, min=1e-30)
    vf = v.to(q.dtype)
    if v_scale is not None:
        p = p * v_scale.float()[:, None, None, None, :]
    p = p.to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", p.float(), vf.float())
    if reduce is not None:
        out = reduce(out, "sum")
    out = out.to(q.dtype)
    if not with_lse:
        return out
    lse = torch.where((m > NEG_INF / 2) & (l > 0), m + torch.log(
        torch.clamp(l, min=1e-30)), torch.tensor(float("-inf"),
                                                 device=q.device))
    return out, lse[..., 0].permute(0, 3, 1, 2)
