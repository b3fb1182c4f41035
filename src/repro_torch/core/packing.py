"""Sub-byte weight packing (the paper's on-chip storage format).

Port of the reference's ``core/packing.py``. ``fields`` b-bit two's-
complement fields per int32 word (10 fields for b=3: 30 bits used, the
paper's 3-bit BRAM words; 16 for b=2; 8 for b=4; 4 for b=8). Matrices pack
along K (the reduction axis) into (ceil(K/f), N) words — the streaming
format of the ``qmatvec`` kernel. The words are bit-identical to the
reference's.
"""
from __future__ import annotations

import math

import torch

__all__ = ["fields_per_word", "packed_words", "packed_nbytes", "pack_int32",
           "unpack_int32", "pack_matrix", "unpack_matrix"]


def fields_per_word(bits: int) -> int:
    """How many b-bit fields fit one int32 word (30 bits used for b=3)."""
    if bits not in (2, 3, 4, 8):
        raise ValueError(f"unsupported pack width: {bits}")
    return {2: 16, 3: 10, 4: 8, 8: 4}[bits]


def packed_words(n: int, bits: int) -> int:
    f = fields_per_word(bits)
    return (n + f - 1) // f


def packed_nbytes(shape, bits: int) -> int:
    """Device bytes for a packed tensor of logical ``shape``."""
    return packed_words(math.prod(shape), bits) * 4


def _check_levels(q: torch.Tensor, bits: int) -> None:
    """Enforce the pack contract: every level must lie in the b-bit two's-
    complement range [-(2^(b-1)), 2^(b-1)-1]. Out-of-range values would be
    silently truncated to their low b bits (a wrong but plausible-looking
    weight) — reject them instead. A meta tensor (a shape-only template)
    has no values to check."""
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    if q.numel() and not q.is_meta:
        qmin, qmax = int(q.min()), int(q.max())
        if qmin < lo or qmax > hi:
            raise ValueError(
                f"levels out of range for {bits}-bit packing: got "
                f"[{qmin}, {qmax}], contract is [{lo}, {hi}]")


def _to_int32_wrapping(x: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 with two's-complement wrap (the
    8-bit format fills bit 31)."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _pack_axis0(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack (..., K, N) levels along K (dim -2) -> (..., ceil(K/f), N)."""
    f = fields_per_word(bits)
    mask = (1 << bits) - 1
    k = q.shape[-2]
    nw = packed_words(k, bits)
    qp = q.to(torch.int64)
    pad = nw * f - k
    if pad:
        qp = torch.nn.functional.pad(qp, (0, 0, 0, pad))
    qp = qp.reshape(*q.shape[:-2], nw, f, q.shape[-1]) & mask
    shifts = (torch.arange(f, dtype=torch.int64, device=q.device)
              * bits).reshape(f, 1)
    return _to_int32_wrapping((qp << shifts).sum(dim=-2))


def _unpack_axis0(words: torch.Tensor, k: int, bits: int) -> torch.Tensor:
    """Inverse of :func:`_pack_axis0` -> (..., K, N) int8."""
    f = fields_per_word(bits)
    mask = (1 << bits) - 1
    sign = 1 << (bits - 1)
    shifts = (torch.arange(f, dtype=torch.int32, device=words.device)
              * bits).reshape(f, 1)
    w = words.to(torch.int32).unsqueeze(-2)             # (..., KP, 1, N)
    fields = (w >> shifts) & mask
    fields = fields - ((fields & sign) << 1)            # sign extend
    out = fields.reshape(*words.shape[:-2], -1, words.shape[-1])
    return out[..., :k, :].to(torch.int8)


def pack_int32(q: torch.Tensor, bits: int = 3) -> torch.Tensor:
    """Pack a flat int array of b-bit signed levels into int32 words.
    Out-of-range levels raise ``ValueError``."""
    _check_levels(q, bits)
    return _pack_axis0(q.reshape(-1, 1), bits)[:, 0]


def unpack_int32(words: torch.Tensor, n: int, bits: int = 3) -> torch.Tensor:
    """Inverse of :func:`pack_int32`; returns int8 levels of length ``n``."""
    return _unpack_axis0(words.reshape(-1, 1), n, bits)[:, 0]


def pack_matrix(q: torch.Tensor, bits: int = 3) -> torch.Tensor:
    """Pack a (..., K, N) int level matrix along K into (..., ceil(K/f), N)
    int32 (leading stacked-layer dims ride along). Out-of-range levels
    raise ``ValueError``."""
    _check_levels(q, bits)
    return _pack_axis0(q, bits)


def unpack_matrix(words: torch.Tensor, k: int, bits: int = 3) -> torch.Tensor:
    """Inverse of :func:`pack_matrix` -> (..., K, N) int8."""
    return _unpack_axis0(words, k, bits)
