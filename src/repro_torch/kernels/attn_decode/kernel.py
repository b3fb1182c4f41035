"""CUDA launch wrapper of the fused decode attention (``csrc/attn_decode.cu``).

The kernel splits the cache along S across blocks and merges the splits'
partial softmax in a second kernel, launched by the same C entry point.
:func:`plan` (pure Python, so the CPU tests reach it) picks the split
length from the cache's static length S, never from ``cache_len``;
:func:`split_softmax` is the arithmetic of the split and the merge in
plain torch, for the CPU tests. The launch is the CUDA implementation of
the registered op ``torch.ops.repro_torch.attn_decode``
(``kernels/_ops.py``), whose fake implementation allocates the same
output and split partials. ``launches`` counts launches (one per call,
the merge included); nothing else touches it. With ``with_lse`` the merge
also returns each head's log-sum-exp of its scores (fp32, (B, KV, G)), the
part a merge of a sequence split across ranks needs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, _ops

__all__ = ["attn_decode_cuda", "check_head", "check_kv", "launches", "plan",
           "Plan", "split_smem", "split_softmax", "attention_flops"]

launches = 0

_BK, _WARPS, _HPW, _PAD = 32, 8, 4, 16    # as csrc/attn_decode.cu
_TARGET_BLOCKS = 8 * 132                   # eight blocks for each SM
_MAX_SPLITS = 1024                         # as csrc/attn_decode.cu
# KV heads a block (G < 5): at most 4, and as many as keep two blocks on
# an SM (measured on the H100: 8 heads a block, one block an SM, ran no
# faster at G = 1 and slower with int8 K/V)
_HB_MAX = 4
_HB_SMEM = _ops.SM_SMEM // 2 - _ops.BLOCK_RESERVED

_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_float]
             + [ctypes.c_int] * 11 + [ctypes.c_void_p])


class Plan(NamedTuple):
    """One launch: keys per split, the number of splits (the grid is
    splits x B * KV / hb blocks), the split kernel's dynamic shared memory
    (bytes) and hb, the KV heads a block serves."""
    split_len: int
    splits: int
    dynamic_smem: int
    hb: int = 1


def split_smem(hb: int, g: int, d: int, kv_dtype: torch.dtype) -> int:
    """The split kernel's dynamic shared memory (csrc/attn_decode.cu,
    ``Smem``): q of hb * g heads in fp32, each warp's P rows, two buffers
    of BK keys of K and V (a row the hb heads' d values, padded) and, for
    int8, their scales."""
    row = hb * d * kv_dtype.itemsize + _PAD
    kv_buf = 2 * _BK * row + (2 * _BK * 4 if kv_dtype == torch.int8 else 0)
    return hb * g * d * 4 + _WARPS * _HPW * _BK * 4 + 2 * kv_buf


@functools.lru_cache(maxsize=None)
def plan(b: int, s: int, kv: int, g: int, d: int,
         kv_dtype: torch.dtype) -> Plan:
    """The launch for a (b, s, kv, d) cache and G heads per KV head.
    hb: 1 for G >= 5; below, 8 // G KV heads a block (at most 4), so the
    warps have heads, as a power of two that divides KV, halved until the
    block's buffers leave room for two blocks on an SM. The split: the
    shortest length (a power of two from 32 keys, one staged block) that
    keeps the grid within about eight blocks per SM (four where a block
    serves 4 KV heads): a block's time grows with its keys, so short
    splits win until the blocks queue; and at most 1024 splits, the
    merge's shared memory. Depends on shapes only."""
    hb = 1
    while 2 * hb * g <= _WARPS and hb < _HB_MAX:
        hb *= 2
    while hb > 1 and (kv % hb or split_smem(hb, g, d, kv_dtype) > _HB_SMEM):
        hb //= 2
    target = _TARGET_BLOCKS * min(hb, 2) // hb
    want = -(-max(s, 1) * b * (kv // hb) // target)
    split_len = _BK
    while split_len < want or -(-max(s, 1) // split_len) > _MAX_SPLITS:
        split_len *= 2
    return Plan(split_len, -(-max(s, 1) // split_len),
                split_smem(hb, g, d, kv_dtype), hb)


def split_softmax(scores: torch.Tensor, v: torch.Tensor, lens: torch.Tensor,
                  split_len: int) -> torch.Tensor:
    """The kernel's softmax-weighted sum in fp32 torch: (B, H, S) scores
    against (B, S, D) values, positions >= lens[b] masked. Each split of
    ``split_len`` keys keeps its own max m, sum l and accumulator, rescaled
    per 32-key block; a split with no visible key gives l = 0, m = -inf.
    The merge takes sum acc e^(m - M) / sum l e^(m - M) over the non-empty
    splits in order (M their largest m); a row with none gives zeros."""
    b, h, s = scores.shape
    nsplit = -(-max(s, 1) // split_len)
    ms, ls, accs = [], [], []
    for sp in range(nsplit):
        m = torch.full((b, h), float("-inf"))
        l = torch.zeros((b, h))
        acc = torch.zeros((b, h, v.shape[-1]))
        for k0 in range(sp * split_len, min(s, (sp + 1) * split_len), _BK):
            k1 = min(k0 + _BK, (sp + 1) * split_len, s)
            pos = torch.arange(k0, k1)
            valid = pos[None, :] < lens[:, None]                 # (B, n)
            sv = torch.where(valid[:, None], scores[..., k0:k1],
                             torch.tensor(float("-inf")))
            mx = sv.amax(-1)
            m_new = torch.where(valid.any(-1)[:, None], torch.maximum(m, mx),
                                m)
            live = m_new > float("-inf")
            corr = torch.where(live, torch.exp(m - m_new), torch.ones(()))
            p = torch.where(valid[:, None],
                            torch.exp(sv - m_new[..., None]), torch.zeros(()))
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhn,bnd->bhd", p,
                                                       v[:, k0:k1])
            m = m_new
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    big = torch.where(l > 0, m, torch.tensor(float("-inf"))).amax(0)
    num = torch.zeros_like(acc[0])
    den = torch.zeros_like(l[0])
    for i in range(nsplit):              # in order; empty splits skipped
        w = torch.where(l[i] > 0, torch.exp(torch.where(
            l[i] > 0, m[i] - big, torch.zeros(()))), torch.zeros(()))
        num = num + acc[i] * w[..., None]
        den = den + l[i] * w
    return torch.where(den[..., None] > 0, num / torch.where(
        den > 0, den, torch.ones(()))[..., None], torch.zeros(()))


def check_head(g: int, d: int, what: str) -> None:
    """The head shapes every attention kernel takes: head_dim a multiple of
    16 from 16 to 256 (a wgmma k-step, and 16-byte rows of an int8 cache),
    and at most 32 query heads per KV head."""
    if d % 16 or not 16 <= d <= 256:
        raise ValueError(f"{what}: head_dim {d} is not a multiple of 16 "
                         f"from 16 to 256")
    if not 1 <= g <= 32:
        raise ValueError(f"{what}: {g} query heads per KV head, need 1..32")


def check_kv(q, k, v, k_scale, v_scale, kv_shape, what: str) -> bool:
    """Shared checks of the attention kernels: q fp32/bf16, the head shape
    of :func:`check_head`, K/V of ``kv_shape`` in q's dtype — or int8 with
    (B, S) fp32 scales, both or neither. Returns whether the cache is
    int8."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} q: need fp32/bf16, got {q.dtype}")
    check_head(q.shape[-2], q.shape[-1], what)
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
                     v_scale: torch.Tensor | None = None,
                     q_scale: float = 1.0, with_lse: bool = False):
    """q (B, KV, G, D) fp32/bf16, multiplied by ``q_scale`` (a scalar
    already rounded to q's dtype) in q's dtype as the kernel reads it; k/v
    cache (B, S, KV, D) in q's dtype, or int8 with (B, S) fp32 scales;
    cache_len (B,) int32 -> (B, KV, G, D) in q's dtype, and with
    ``with_lse`` also the (B, KV, G) fp32 log-sum-exp of each head's
    visible scores (-inf where none is visible). Checks what the kernel
    does not handle, then calls the registered op
    ``torch.ops.repro_torch.attn_decode``."""
    if not q.is_cuda or q.dim() != 4 or not q.is_contiguous():
        raise ValueError(f"attn_decode q: need a contiguous (B, KV, G, D) "
                         f"CUDA tensor, got {tuple(q.shape)} on {q.device}")
    b, kv, g, d = q.shape
    s = k_cache.shape[1]
    check_kv(q, k_cache, v_cache, k_scale, v_scale, (b, s, kv, d),
             "attn_decode")
    _build.require(cache_len, (b,), (torch.int32,), q.device,
                   "attn_decode cache_len")
    out, lse = _ops.op("attn_decode")(q, k_cache, v_cache, cache_len,
                                      k_scale, v_scale, float(q_scale),
                                      bool(with_lse))
    return (out, lse) if with_lse else out


def _alloc(q, k_cache, with_lse):
    """The launch's plan, its output, its log-sum-exp ((B, KV, G) fp32
    with ``with_lse``, else empty) and its split partials (the m, l and
    accumulator of every split, one fp32 buffer), noted for a recording;
    shared by both implementations of the op."""
    b, kv, g, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, kv, g) if with_lse else (0,), dtype=torch.float32,
                      device=q.device)
    if b * kv == 0:
        return None, out, lse, None
    p = plan(b, k_cache.shape[1], kv, g, d, k_cache.dtype)
    parts = torch.empty((b * kv * p.splits * g * (d + 2),),
                        dtype=torch.float32, device=q.device)
    _ops.note("attn_decode", "", (p.splits, b * kv // p.hb), p.dynamic_smem,
              [(parts.shape, parts.dtype)], p)
    return p, out, lse, parts


def _launch(q, k_cache, v_cache, cache_len, k_scale, v_scale, q_scale,
            with_lse=False):
    """The op's CUDA implementation: the split and merge kernels on the
    current stream."""
    global launches
    p, out, lse, parts = _alloc(q, k_cache, with_lse)
    if p is None:
        return out, lse
    b, kv, g, d = q.shape
    s = k_cache.shape[1]
    quantized = k_scale is not None
    pm = parts[:b * kv * p.splits * g]
    pl = parts[pm.numel():2 * pm.numel()]
    pacc = parts[2 * pm.numel():]
    with torch.cuda.device(q.device):
        rc = _build.function("attn_decode", _ARGTYPES)(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            cache_len.data_ptr(), out.data_ptr(), pm.data_ptr(),
            pl.data_ptr(), pacc.data_ptr(),
            lse.data_ptr() if with_lse else None, q_scale, b, s, kv, g, d,
            _build.dtype_code(q.dtype), _build.dtype_code(k_cache.dtype),
            p.hb, p.split_len, p.splits, p.dynamic_smem,
            _build.stream_ptr(q.device))
    _build.check(rc, "attn_decode")
    launches += 1
    return out, lse


def _fake(q, k_cache, v_cache, cache_len, k_scale, v_scale, q_scale,
          with_lse=False):
    """The op's fake implementation: the launch's allocations, no work."""
    _, out, lse, _ = _alloc(q, k_cache, with_lse)
    return out, lse


def attention_flops(b: int, h: int, t: int, s: int, d: int) -> int:
    """4 B H T S D: the score product and the value product, each
    2 B H T S D, over every key position before masking."""
    return 4 * b * h * t * s * d


def _flops(q, k_cache, v_cache, cache_len, k_scale, v_scale, q_scale,
           with_lse=False, out_shape=None):
    b, kv, g, d = q
    return attention_flops(b, kv * g, 1, k_cache[1], d)


_ops.define("attn_decode", "(Tensor q, Tensor k_cache, Tensor v_cache, "
            "Tensor cache_len, Tensor? k_scale, Tensor? v_scale, "
            "float q_scale, bool with_lse=False) -> (Tensor, Tensor)", _launch,
            _fake, _flops)
