"""Plain PyTorch version of the fused decode attention (the reference's
``attn_decode/ref.py``): the CPU path of ``ops.attn_decode`` and the oracle
the CUDA kernel is held against.

fp32 scores and softmax statistics; int8-cache scales factored where the
kernel applies them (k_scale after Q.K, v_scale into the probabilities
before P.V); probabilities cast to the compute dtype for P.V; one cast back
to q's dtype. Rows with ``cache_len == 0`` return zeros. ``calls`` counts
its uses, and also the model-level reference decode path
(``models.attention.decode_attention(mode="ref")``) that stands in for the
kernel.
"""
from __future__ import annotations

import torch

__all__ = ["attn_decode_ref", "scale_q", "NEG_INF", "calls"]

NEG_INF = -1e30
calls = 0


def scale_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * scale in q's dtype, the scalar rounded to that dtype first (JAX's
    weakly typed scalar multiply). The scalar is rounded on the host: a
    scalar tensor copied to the card would synchronise the stream, which no
    captured graph may do."""
    return q * torch.tensor(scale, dtype=q.dtype).item()


def attn_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, cache_len,
                    k_scale: torch.Tensor | None = None,
                    v_scale: torch.Tensor | None = None,
                    with_lse: bool = False, reduce=None):
    """q (B, 1, H, D); k/v cache (B, S, KV, D); cache_len scalar or (B,);
    optional (B, S) per-token scales for an int8 cache -> (B, 1, H, D); with
    ``with_lse`` also the (B, H) fp32 log-sum-exp of each head's visible
    scores, m + log(l) (-inf for a row with none), as the kernel's merge
    gives it. ``reduce(t, op)``, where given, all-reduces the row max, the
    sum and the P . V sums across the ranks that hold the rest of a
    sequence-sharded cache (``shards.decode_on_shards``), so the ranks
    compute what one process would, to fp32 summation order."""
    global calls
    calls += 1
    b, _, h, d = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    qr = scale_q(q, 1.0 / (d ** 0.5)).reshape(b, 1, kvh, g, d)
    kc = k_cache if k_scale is None else k_cache.to(q.dtype)
    sc = torch.einsum("bqkgd,bskd->bkgqs", qr.float(), kc.float())
    if k_scale is not None:
        sc = sc * k_scale[:, None, None, None, :].float()
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = torch.arange(s, device=q.device)[None, :] < lens.expand(b, s)
    sc = torch.where(valid[:, None, None, None], sc,
                     torch.tensor(NEG_INF, device=q.device))
    m = sc.amax(dim=-1, keepdim=True)
    if reduce is not None:
        m = reduce(m, "max")
    p = torch.where(m > NEG_INF / 2, torch.exp(sc - m), torch.zeros_like(sc))
    l = p.sum(dim=-1, keepdim=True)
    if reduce is not None:
        l = reduce(l, "sum")
    l = torch.clamp(l, min=1e-30)
    if v_scale is not None:
        p = (p * v_scale[:, None, None, None, :].float()).to(q.dtype)
        vc = v_cache.to(q.dtype)
    else:
        p = p.to(v_cache.dtype)
        vc = v_cache
    out = torch.einsum("bkgqs,bskd->bqkgd", p.float(), vc.float())
    if reduce is not None:
        out = reduce(out, "sum")
    out = (out / l.permute(0, 3, 1, 2, 4)).reshape(b, 1, h, d).to(q.dtype)
    if not with_lse:
        return out
    lse = torch.where(m > NEG_INF / 2, m + torch.log(l),
                      torch.tensor(float("-inf"), device=q.device))
    return out, lse.reshape(b, h)
