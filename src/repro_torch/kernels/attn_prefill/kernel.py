"""CUDA launch wrappers of the blocked prefill attention.

Two kernels, chosen by the queries' dtype in :func:`plan` (pure Python, so
the CPU tests reach it), neither a fallback for the other:
- ``wgmma`` (``csrc/attn_prefill_tc.cu``): bf16 queries with a bf16 or int8
  K/V, on the tensor cores;
- ``simt`` (``csrc/attn_prefill.cu``): fp32 queries with an fp32 or int8
  K/V, on the CUDA cores in fp32, as the fp32 parity gates require; the
  plan also sizes its key block to the shared memory and splits S across
  blocks where the grid would leave SMs idle (a second kernel merges).
Both take every head_dim that is a multiple of 16 from 16 to 256
(``attn_decode.kernel.check_head``). Any other combination raises.
``launches`` counts wrapper calls that launched (one a call) and
``launches_by_variant`` splits them by kernel; ``merges`` counts the simt
split's second kernel, one for each call that splits S. Nothing else
touches them. Both kernels are the CUDA implementation of one registered
op, ``torch.ops.repro_torch.attn_prefill`` (``kernels/_ops.py``), whose
fake implementation allocates the same output and split partials.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, _ops
from repro_torch.kernels.attn_decode.kernel import (attention_flops,
                                                   check_head, check_kv)

__all__ = ["attn_prefill_cuda", "plan", "Plan", "launches",
           "launches_by_variant", "merges", "VARIANTS"]

VARIANTS = ("wgmma", "simt")
launches = 0
launches_by_variant = dict.fromkeys(VARIANTS, 0)
merges = 0                     # the simt split's merge kernel

# wgmma: 64 flattened (t, g) query rows and key blocks of 64 per block
_TC_ROWS, _TC_BK = 64, 64
# simt, as csrc/attn_prefill.cu: 64 rows a block, key blocks of 64 or 32
_SIMT_ROWS, _SIMT_BKS = 64, (64, 32)
SMEM_LIMIT = 232448            # shared memory one block may use, H100
_TARGET_BLOCKS = 132           # one block for each SM

# the launch functions: 8 pointers, 8 ints (wgmma); 10 pointers, 11 ints
# (simt); the stream
_TC_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_SIMT_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 11
                  + [ctypes.c_void_p])


class Plan(NamedTuple):
    """One launch: the kernel, the dynamic shared memory it asks for
    (bytes) and, for simt, the keys a staged block, the splits of S across
    blocks and the key positions a split. The launcher sizes the grid:
    B * KV * ceil(T G / 64) x splits."""
    variant: str
    dynamic_smem: int
    key_block: int = 0
    splits: int = 1
    split_len: int = 0


def _simt_smem(d: int, bk: int, quantized: bool) -> int:
    """The simt kernel's shared memory (csrc/attn_prefill.cu, ``Smem``), in
    bytes: Q (64 x D + 4 fp32), the K and V tiles (BK x D + 4; two buffers,
    or one for an int8 K/V, which lands as bytes in two raw buffers with
    its scales), P (64 x BK + 4) and the rows' windows."""
    ld = d + 4
    words = (_SIMT_ROWS * ld + (2 if quantized else 4) * bk * ld
             + _SIMT_ROWS * (bk + 4) + 2 * _SIMT_ROWS)
    if quantized:
        words += 2 * (2 * bk * d // 4 + 2 * bk)
    return 4 * words


@functools.lru_cache(maxsize=None)
def plan(q_dtype: torch.dtype, kv_dtype: torch.dtype, g: int, d: int,
         b: int = 1, t: int = 1, kv: int = 1, s: int = 1) -> Plan:
    """The kernel for queries of ``q_dtype`` (G heads per KV head, head_dim
    D) against a K/V of ``kv_dtype``; for simt, the launch for B rows of T
    queries and KV heads against S key positions: key blocks of 64 where
    the shared memory holds two buffers of them, else 32; S split into
    slices of whole key blocks while the grid has fewer blocks than SMs.
    Raises for a combination no kernel takes."""
    check_head(g, d, "attn_prefill")
    if q_dtype == torch.bfloat16 and kv_dtype in (torch.bfloat16, torch.int8):
        tile = _TC_BK * d * 2
        if kv_dtype == torch.int8:      # bf16 blocks, 2 int8 buffers, scales
            kv_bytes = 2 * tile + 4 * _TC_BK * d + 4 * _TC_BK * 4
        else:                           # 2 buffers of bf16 K and V blocks
            kv_bytes = 4 * tile
        return Plan("wgmma", _TC_ROWS * d * 2 + kv_bytes)
    if q_dtype == torch.float32 and kv_dtype in (torch.float32, torch.int8):
        quantized = kv_dtype == torch.int8
        bk = next(k for k in _SIMT_BKS
                  if _simt_smem(d, k, quantized) <= SMEM_LIMIT)
        blocks = b * kv * -(-(t * g) // _SIMT_ROWS)
        keys = -(-max(s, 1) // bk)
        want = min(-(-_TARGET_BLOCKS // max(blocks, 1)), keys)
        split_len = -(-keys // want) * bk
        return Plan("simt", _simt_smem(d, bk, quantized), bk,
                    -(-max(s, 1) // split_len), split_len)
    raise ValueError(f"attn_prefill: no kernel takes {q_dtype} queries with "
                     f"a {kv_dtype} K/V (bf16 with bf16/int8, fp32 with "
                     f"fp32/int8)")


def attn_prefill_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lo: torch.Tensor | None, hi: torch.Tensor,
                      k_scale: torch.Tensor | None = None,
                      v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """q (B, T, KV, G, D) fp32/bf16 pre-scaled by 1/sqrt(D); k/v
    (B, S, KV, D) in q's dtype, or int8 with (B, S) fp32 scales; lo/hi
    (B, T) int32, lo None for all zeros -> (B, T, KV, G, D) in q's
    dtype. Checks what the kernels do not handle, then calls the
    registered op ``torch.ops.repro_torch.attn_prefill``."""
    if not q.is_cuda or q.dim() != 5 or not q.is_contiguous():
        raise ValueError(f"attn_prefill q: need a contiguous (B, T, KV, G, D)"
                         f" CUDA tensor, got {tuple(q.shape)} on {q.device}")
    b, t, kv, g, d = q.shape
    s = k.shape[1]
    plan(q.dtype, k.dtype, g, d, b, t, kv, s)
    check_kv(q, k, v, k_scale, v_scale, (b, s, kv, d), "attn_prefill")
    if lo is not None:
        _build.require(lo, (b, t), (torch.int32,), q.device, "attn_prefill lo")
    _build.require(hi, (b, t), (torch.int32,), q.device, "attn_prefill hi")
    return _ops.op("attn_prefill")(q, k, v, lo, hi, k_scale, v_scale)


def _alloc(q, k):
    """The launch's plan, its output and the simt split's partials (the m,
    l and accumulator of every split, one fp32 buffer; None without a
    split), noted for a recording; shared by both implementations."""
    b, t, kv, g, d = q.shape
    s = k.shape[1]
    out = torch.empty_like(q)
    if b * t * kv == 0:
        return None, out, None
    p = plan(q.dtype, k.dtype, g, d, b, t, kv, s)
    part = None
    if p.variant == "simt" and p.splits > 1:
        part = torch.empty((p.splits * b * kv * t * g * (d + 2),),
                           dtype=torch.float32, device=q.device)
    rows = _TC_ROWS if p.variant == "wgmma" else _SIMT_ROWS
    _ops.note("attn_prefill", p.variant,
              (b * kv * -(-(t * g) // rows), p.splits), p.dynamic_smem,
              [] if part is None else [(part.shape, part.dtype)], p)
    return p, out, part


def _launch(q, k, v, lo, hi, k_scale, v_scale):
    """The op's CUDA implementation: the launch on the current stream (and
    the simt split's merge)."""
    global launches, merges
    p, out, part = _alloc(q, k)
    if p is None:
        return out
    b, t, kv, g, d = q.shape
    s = k.shape[1]
    quantized = k_scale is not None
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            None if lo is None else lo.data_ptr(), hi.data_ptr(),
            out.data_ptr())
    with torch.cuda.device(q.device):
        if p.variant == "wgmma":
            rc = _build.function("attn_prefill_tc", _TC_ARGTYPES)(
                *ptrs, b, t, s, kv, g, d, _build.dtype_code(k.dtype),
                p.dynamic_smem, _build.stream_ptr(q.device))
        else:
            rows = p.splits * b * kv * t * g
            rc = _build.function("attn_prefill", _SIMT_ARGTYPES)(
                *ptrs, None if part is None else part.data_ptr(),
                None if part is None else part[2 * rows:].data_ptr(),
                b, t, s, kv, g, d, _build.dtype_code(k.dtype), p.key_block,
                p.split_len, p.splits, p.dynamic_smem,
                _build.stream_ptr(q.device))
    _build.check(rc, f"attn_prefill ({p.variant})")
    launches += 1
    launches_by_variant[p.variant] += 1
    if p.variant == "simt" and p.splits > 1:
        merges += 1
    return out


def _fake(q, k, v, lo, hi, k_scale, v_scale):
    """The op's fake implementation: the launch's allocations, no work."""
    return _alloc(q, k)[1]


def _flops(q, k, v, lo, hi, k_scale, v_scale, out_shape=None):
    b, t, kv, g, d = q
    return attention_flops(b, kv * g, t, k[1], d)


_ops.define("attn_prefill", "(Tensor q, Tensor k, Tensor v, Tensor? lo, "
            "Tensor hi, Tensor? k_scale, Tensor? v_scale) -> Tensor",
            _launch, _fake, _flops)
