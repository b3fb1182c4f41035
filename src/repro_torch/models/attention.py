"""Attention: GQA prefill and decode, kernel-dispatched on ``mode``.

Port of the reference's ``models/attention.py`` (the dense serve path).
Shapes: q (B, Lq, H, D); k/v (B, Lkv, KV, D); GQA groups G = H // KV.

  * ``decode_attention`` -> the ``attn_decode`` CUDA kernel ('kernel') or
    the einsum reference ('ref');
  * ``prefill_attention`` -> the ``attn_prefill`` CUDA kernel with the
    bucketed-prefill rule (query t sees key j iff j <= t AND
    j < lengths[row]) or the chunked online-softmax reference, which masks
    causally only: identical at every real query position, while padded
    query rows (t >= lengths[row]) may differ — their cache entries are
    masked downstream and overwritten as the row advances;
  * ``verify_attention`` (speculative verify: T = spec_k + 1 queries
    against the whole decode cache) -> the same ``attn_prefill`` kernel
    with ``hi = valid`` or the masked-einsum reference.

'auto' picks the kernel for CUDA tensors, the reference elsewhere. The
reference paths add to the kernels' plain-version counters
(``kernels.<name>.ref.calls``), so a run can show it never left the
kernels. A sliding window (``prefill_attention(window=)``) raises the
kernel's lower bound to ``lo = max(t - window + 1, 0)``; its reference is
``sliding_window_attention``. DTensor operands run the kernels on their
shards (``distributed.shards.attention_on_shards``, the key sequence
gathered); the reference paths first gather query heads that the keys'
heads are not sharded alike with (``shards.align_heads``).
"""
from __future__ import annotations

import torch

from repro_torch.distributed import shards
from repro_torch.kernels.attn_decode import ops as dec_ops
from repro_torch.kernels.attn_decode import ref as dec_ref
from repro_torch.kernels.attn_decode.ref import scale_q
from repro_torch.kernels.attn_prefill import ops as pf_ops
from repro_torch.kernels.attn_prefill import ref as pf_ref

__all__ = ["chunked_attention", "decode_attention", "prefill_attention",
           "sliding_window_attention", "verify_attention",
           "resolve_attn_mode", "ATTN_MODES"]

NEG_INF = -1e30

ATTN_MODES = ("auto", "kernel", "ref")


def resolve_attn_mode(mode: str, device=None) -> str:
    """'auto' -> the CUDA kernels for CUDA tensors, the reference
    elsewhere."""
    if mode == "auto":
        return "kernel" if torch.device(device or "cpu").type == "cuda" \
            else "ref"
    if mode not in ("kernel", "ref"):
        raise ValueError(f"attn mode must be one of {ATTN_MODES}, "
                         f"got {mode!r}")
    return mode


def _neg_inf(like: torch.Tensor) -> torch.Tensor:
    return torch.full((), NEG_INF, dtype=torch.float32, device=like.device)


def _guarded_softmax(sc: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis of NEG_INF-masked fp32 scores; a row whose
    every slot is masked gives exact zeros (not the uniform average or
    NaN), matching the kernels."""
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(m > NEG_INF / 2, torch.exp(sc - m), torch.zeros_like(sc))
    return p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      chunk: int = 1024) -> torch.Tensor:
    """Causal online-softmax attention over KV chunks (memory
    O(seq * chunk)), q[0] at key position 0 — the reference's
    ``chunked_attention`` as prefill calls it."""
    b, lq, h, d = q.shape
    lkv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    chunk = min(chunk, lkv)
    qr = scale_q(q, 1.0 / (d ** 0.5)).reshape(b, lq, kvh, g, d).float()
    q_pos = torch.arange(lq, device=q.device)
    m = torch.full((b, kvh, g, lq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, g, lq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, g, lq, d), dtype=torch.float32, device=q.device)
    for c0 in range(0, lkv, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = shards.einsum("bqkgd,bckd->bkgqc", qr, kb.float())
        kv_pos = c0 + torch.arange(kb.shape[1], device=q.device)
        mask = kv_pos[None, :] <= q_pos[:, None]
        s = torch.where(mask[None, None, None], s, _neg_inf(s))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # empty-row guard: rows with no valid position yet keep p = 0
        alive = m_new > NEG_INF / 2
        p = torch.where(alive[..., None], torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        corr = torch.where(alive, torch.exp(m - m_new), torch.ones_like(m))
        l = l * corr + p.sum(dim=-1)
        pv = shards.einsum("bkgqc,bckd->bkgqd", p.to(v.dtype).float(),
                           vb.float()).to(v.dtype).float()
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, lq, h, d).to(q.dtype)


def sliding_window_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, window: int,
                             chunk: int = 1024) -> torch.Tensor:
    """Causal sliding-window attention, query t seeing keys
    t - window < p <= t — the reference's ``sliding_window_attention``:
    queries in chunks, each against the static span of ``window + chunk``
    keys that ends with it (K/V left-padded by ``window``), plain masked
    softmax over the span."""
    b, lq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    chunk = min(chunk, lq)
    nq = -(-lq // chunk)
    pad = nq * chunk - lq
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, window, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, window, pad))
    span = window + chunk
    outs = []
    for i in range(nq):
        s0 = i * chunk
        qr = scale_q(qp[:, s0:s0 + chunk], 1.0 / (d ** 0.5)).reshape(
            b, chunk, kvh, g, d)
        kb, vb = kp[:, s0:s0 + span], vp[:, s0:s0 + span]
        sc = torch.einsum("bqkgd,bckd->bkgqc", qr.float(), kb.float())
        qpos = s0 + torch.arange(chunk, device=q.device)
        kpos = s0 - window + torch.arange(span, device=q.device)
        mask = ((kpos[None, :] <= qpos[:, None])
                & (kpos[None, :] > qpos[:, None] - window)
                & (kpos[None, :] >= 0) & (kpos[None, :] < lq))
        sc = torch.where(mask[None, None, None], sc, _neg_inf(sc))
        p = torch.softmax(sc, dim=-1).to(v.dtype)
        o = torch.einsum("bkgqc,bckd->bqkgd", p.float(), vb.float())
        outs.append(o.to(v.dtype).reshape(b, chunk, h, d))
    return torch.cat(outs, dim=1)[:, :lq].to(q.dtype)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      lengths=None, window: int = 0, mode: str = "auto",
                      chunk: int = 1024) -> torch.Tensor:
    """Prompt self-attention for prefill/admission: q (B, T, H, D) against
    k/v (B, T, KV, D); ``lengths`` (B,) optional per-row valid prompt
    lengths (bucketed admission right-pads rows to the bucket); ``window``
    > 0 also hides keys at or before t - window from query t."""
    if resolve_attn_mode(mode, q.device) == "kernel":
        b, t = q.shape[0], q.shape[1]
        pos = torch.arange(t, dtype=torch.int32, device=q.device)
        hi = (pos[None, :] + 1).expand(b, t)
        if lengths is not None:
            lens = torch.as_tensor(lengths, device=q.device).to(torch.int32)
            hi = torch.minimum(hi, lens.reshape(-1, 1).expand(b, 1))
        lo = None
        if window:
            lo = torch.clamp(pos - (window - 1), min=0)[None, :].expand(b, t)
        if shards.any_dtensor(q, k, v):
            return shards.attention_on_shards(
                lambda q_, k_, v_, hi_, lo_: pf_ops.attn_prefill(
                    q_, k_, v_, hi_, lo=lo_), q, k, v, rows=(hi, lo))
        return pf_ops.attn_prefill(q, k, v, hi, lo=lo)
    q, k, v = shards.align_heads(q, k, v)
    pf_ref.calls += 1
    if window:
        return sliding_window_attention(q, k, v, window=window, chunk=chunk)
    return chunked_attention(q, k, v, chunk=chunk)


def verify_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid: torch.Tensor,
                     k_scale=None, v_scale=None, *,
                     mode: str = "auto") -> torch.Tensor:
    """Multi-token decode attention for speculative verify: q (B, T, H, D)
    against a (B, S, KV, D) cache; ``valid`` (B, T) is the number of
    visible cache entries per query (its own just-written position
    included), so the T positions are masked causally against each other
    and against the live prefix. 'kernel' runs the ``attn_prefill`` kernel
    with ``hi = valid``; 'ref' is the reference's einsum term for term (the
    T > 1 generalisation of ``decode_attention``'s reference, with the
    same int8 scale factoring) with the guarded softmax, so a query with no
    valid key gives zeros."""
    if resolve_attn_mode(mode, q.device) == "kernel":
        if shards.any_dtensor(q, k_cache, v_cache):
            return shards.attention_on_shards(
                lambda q_, k_, v_, hi_, ks_, vs_: pf_ops.attn_prefill(
                    q_, k_, v_, hi_, k_scale=ks_, v_scale=vs_),
                q, k_cache, v_cache, rows=(valid,),
                row_seq=(k_scale, v_scale))
        return pf_ops.attn_prefill(q, k_cache, v_cache, valid,
                                   k_scale=k_scale, v_scale=v_scale)
    q, k_cache, v_cache, k_scale, v_scale = shards.align_heads(
        q, k_cache, v_cache, k_scale, v_scale)
    pf_ref.calls += 1
    b, t, h, d = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    qr = scale_q(q, 1.0 / (d ** 0.5)).reshape(b, t, kvh, g, d)
    kc = k_cache if k_scale is None else k_cache.to(q.dtype)
    sc = torch.einsum("bqkgd,bskd->bkgqs", qr.float(), kc.float())
    if k_scale is not None:
        sc = sc * k_scale[:, None, None, None, :]
    valid = torch.as_tensor(valid, device=q.device).reshape(b, t)
    mask = torch.arange(s, device=q.device)[None, None, :] < valid[:, :, None]
    sc = torch.where(mask[:, None, None], sc, _neg_inf(sc))
    p = _guarded_softmax(sc)
    if v_scale is not None:
        p = (p * v_scale[:, None, None, None, :]).to(q.dtype)
        vc = v_cache.to(q.dtype)
    else:
        p = p.to(v_cache.dtype)
        vc = v_cache
    out = torch.einsum("bkgqs,bskd->bqkgd", p.float(), vc.float()).to(vc.dtype)
    return out.reshape(b, t, h, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, k_scale=None,
                     v_scale=None, *, mode: str = "auto") -> torch.Tensor:
    """One-token attention against a (B, S, KV, D) cache. q: (B, 1, H, D);
    ``cache_len`` scalar or (B,) valid entries; for an int8 cache pass the
    per-token ``k_scale``/``v_scale`` (B, S), which factor exactly through
    the score and value contractions."""
    if resolve_attn_mode(mode, q.device) == "kernel":
        if shards.any_dtensor(q, k_cache, v_cache):
            return shards.attention_on_shards(
                dec_ops.attn_decode, q, k_cache, v_cache,
                rows=(torch.as_tensor(cache_len, device=q.device),),
                row_seq=(k_scale, v_scale))
        return dec_ops.attn_decode(q, k_cache, v_cache, cache_len, k_scale,
                                   v_scale)
    q, k_cache, v_cache, k_scale, v_scale = shards.align_heads(
        q, k_cache, v_cache, k_scale, v_scale)
    dec_ref.calls += 1
    b, _, h, d = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    qr = scale_q(q, 1.0 / (d ** 0.5)).reshape(b, 1, kvh, g, d)
    kc = k_cache if k_scale is None else k_cache.to(q.dtype)
    sc = torch.einsum("bqkgd,bskd->bkgqs", qr.float(), kc.float())
    if k_scale is not None:
        sc = sc * k_scale[:, None, None, None, :]
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = torch.arange(s, device=q.device)[None, :] < lens.expand(b, s)
    sc = torch.where(valid[:, None, None, None], sc, _neg_inf(sc))
    p = torch.softmax(sc, dim=-1)
    if v_scale is not None:
        p = (p * v_scale[:, None, None, None, :]).to(q.dtype)
        vc = v_cache.to(q.dtype)
    else:
        p = p.to(v_cache.dtype)
        vc = v_cache
    out = torch.einsum("bkgqs,bskd->bqkgd", p.float(), vc.float()).to(vc.dtype)
    return out.reshape(b, 1, h, d).to(q.dtype)
