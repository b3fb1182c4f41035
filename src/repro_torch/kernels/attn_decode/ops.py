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

__all__ = ["attn_decode", "prescale_q", "merge_lse"]


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
                v_scale: torch.Tensor | None = None, with_lse: bool = False,
                reduce=None):
    """Fused one-token GQA attention: q (B, 1, H, D) x cache (B, S, KV, D)
    -> (B, 1, H, D) in q's dtype; with ``with_lse`` also the (B, H) fp32
    log-sum-exp of each head's visible scores (-inf where none is).
    ``reduce(t, op)``, where given, all-reduces across the ranks holding
    the rest of a sequence-sharded cache (``shards.decode_on_shards``):
    the kernel's output and log-sum-exp are merged (:func:`merge_lse`);
    the plain version reduces its softmax statistics as it goes."""
    if q.device.type == "cpu":
        return ref.attn_decode_ref(q, k_cache, v_cache, cache_len,
                                   k_scale, v_scale, with_lse=with_lse,
                                   reduce=reduce)
    if not q.is_cuda:
        raise ValueError(f"attn_decode: no path for device {q.device}")
    b, _, h, d = q.shape
    kv = k_cache.shape[2]
    q4 = q.reshape(b, kv, h // kv, d).contiguous()
    lens = torch.as_tensor(cache_len, device=q.device).to(torch.int32)
    lens = lens.reshape(-1).expand(b).contiguous()
    want_lse = with_lse or reduce is not None
    res = kernel.attn_decode_cuda(q4, k_cache, v_cache, lens, k_scale,
                                  v_scale, q_scale=_q_scale(d, q.dtype),
                                  with_lse=want_lse)
    if not want_lse:
        return res.reshape(b, 1, h, d)
    out, lse = res[0].reshape(b, 1, h, d), res[1].reshape(b, 1, h)
    if reduce is not None:
        out, lse = merge_lse(out, lse, reduce)
    return (out, lse.reshape(b, h)) if with_lse else out


def merge_lse(out: torch.Tensor, lse: torch.Tensor, reduce):
    """Merge the ranks' attention over their own keys: ``out`` (..., D)
    in q's dtype and its fp32 log-sum-exp ``lse`` (the leading dims of
    ``out``; -inf where a rank saw no key), all-reduced by ``reduce(t,
    op)`` as out = sum w o / sum w with w = e^(lse - max lse), in fp32.
    Returns the merged (out, lse); a query no rank saw gives zeros and
    -inf."""
    big = reduce(lse, "max")
    w = torch.where(lse > float("-inf"), torch.exp(lse - big),
                    torch.zeros((), device=out.device))
    num = reduce(out.float() * w[..., None], "sum")
    den = reduce(w, "sum")
    out = torch.where(den[..., None] > 0, num / torch.where(
        den > 0, den, 1.0)[..., None],
        torch.zeros((), device=out.device)).to(out.dtype)
    lse = torch.where(den > 0, big + torch.log(torch.where(
        den > 0, den, 1.0)), torch.full_like(den, float("-inf")))
    return out, lse
