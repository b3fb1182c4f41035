"""CUDA launch wrapper of the fused decode attention (``csrc/attn_decode.cu``).

The kernel splits the cache along S across blocks and merges the splits'
partial softmax in a second kernel, launched by the same C entry point.
:func:`plan` (pure Python, so the CPU tests reach it) picks the split
length from the cache's static length S, never from ``cache_len``;
:func:`split_softmax` is the arithmetic of the split and the merge in
plain torch, for the CPU tests. ``launches`` counts wrapper calls that
launched (one per call, the merge included); nothing else touches it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

__all__ = ["attn_decode_cuda", "check_head", "check_kv", "launches", "plan",
           "Plan", "split_softmax"]

launches = 0

_BK, _WARPS, _HPW, _PAD = 32, 8, 4, 16    # as csrc/attn_decode.cu
_TARGET_BLOCKS = 8 * 132                   # eight blocks for each SM
_MAX_SPLITS = 1024                         # as csrc/attn_decode.cu

_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_float]
             + [ctypes.c_int] * 10 + [ctypes.c_void_p])


class Plan(NamedTuple):
    """One launch: keys per split, the number of splits (the grid is
    splits x B * KV blocks) and the split kernel's dynamic shared memory
    (bytes)."""
    split_len: int
    splits: int
    dynamic_smem: int


@functools.lru_cache(maxsize=None)
def plan(b: int, s: int, kv: int, g: int, d: int,
         kv_dtype: torch.dtype) -> Plan:
    """The split of a (b, s, kv, d) cache for G heads per KV head: the
    shortest split length (a power of two from 32 keys, one staged block)
    that keeps the grid within about eight blocks per SM: a block's time
    grows with its keys, so short splits win until the blocks queue; and at
    most 1024 splits, the merge's shared memory. Depends on shapes only."""
    want = -(-max(s, 1) * b * kv // _TARGET_BLOCKS)
    split_len = _BK
    while split_len < want or -(-max(s, 1) // split_len) > _MAX_SPLITS:
        split_len *= 2
    row = d * torch.empty((), dtype=kv_dtype).element_size() + _PAD
    kv_buf = 2 * _BK * row + (2 * _BK * 4 if kv_dtype == torch.int8 else 0)
    smem = g * d * 4 + _WARPS * _HPW * _BK * 4 + 2 * kv_buf
    return Plan(split_len, -(-max(s, 1) // split_len), smem)


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
                     q_scale: float = 1.0) -> torch.Tensor:
    """q (B, KV, G, D) fp32/bf16, multiplied by ``q_scale`` (a scalar
    already rounded to q's dtype) in q's dtype as the kernel reads it; k/v
    cache (B, S, KV, D) in q's dtype, or int8 with (B, S) fp32 scales;
    cache_len (B,) int32 -> (B, KV, G, D) in q's dtype."""
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
    p = plan(b, s, kv, g, d, k_cache.dtype)
    parts = torch.empty((b * kv * p.splits * g * (d + 2),),
                        dtype=torch.float32, device=q.device)
    pm = parts[:b * kv * p.splits * g]
    pl = parts[pm.numel():2 * pm.numel()]
    pacc = parts[2 * pm.numel():]
    with torch.cuda.device(q.device):
        rc = _build.function("attn_decode", _ARGTYPES)(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            cache_len.data_ptr(), out.data_ptr(), pm.data_ptr(),
            pl.data_ptr(), pacc.data_ptr(), q_scale, b, s, kv, g, d,
            _build.dtype_code(q.dtype), _build.dtype_code(k_cache.dtype),
            p.split_len, p.splits, p.dynamic_smem,
            _build.stream_ptr(q.device))
    _build.check(rc, "attn_decode")
    launches += 1
    return out
