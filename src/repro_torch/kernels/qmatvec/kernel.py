"""CUDA launch wrapper of the packed-container matmul (``csrc/qmatvec.cu``).

Takes 2-D operands already on the card, checks everything the kernel does
not handle itself, allocates the output and launches on the current stream.
:func:`plan` (pure Python, so the CPU tests reach it) picks the variant by
M — ``decode`` (M <= 16) or ``prefill`` — and the tile shape and K split
of the launch. :func:`fragment_product` is the kernel's K permutation and
level decoding in plain torch, for the CPU tests. ``launches`` counts
launches and ``launches_by_variant`` splits them by variant; nothing else
touches either.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

__all__ = ["qmatvec_cuda", "launches", "launches_by_variant", "VARIANTS",
           "FIELDS", "plan", "Plan", "x_planes", "fragment_product"]

FIELDS = 10                    # 3-bit fields per int32 container word
VARIANTS = ("decode", "prefill")
launches = 0
launches_by_variant = dict.fromkeys(VARIANTS, 0)

# as csrc/qmatvec.cu: 8 warps a block, chunks of 80 K (8 words), x rows
# padded by 8 bf16
_WARPS, _CHUNK_WORDS, _CHUNK_K, _XPAD = 8, 8, 80, 8
_DECODE_MAX_M = 16
_STAGE_MIN_M = 256             # from here prefill stages 64-row x tiles
_TARGET_BLOCKS = 132           # one block for each SM of the H100
_MIN_BLOCKS = 48               # unstaged tiles: SMs enough for the bytes
_MAX_WALK = 4                  # unstaged tiles: chunks a warp walks, at most
_MAX_KSPLIT = 16
_X_STAGE_BYTES = 96 * 1024     # staged x a block, at most
_BIAS4 = 0x24924924            # bit 2 of every 3-bit field

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 13
             + [ctypes.c_void_p])
_FLOATS = (torch.float32, torch.bfloat16)


class Plan(NamedTuple):
    """One launch: the variant, 8-row tiles of x a block (``nt``), column
    groups of 32 a block (``cg``; the block's other 8 / cg warps split its
    K), slices of K across blocks (``ksplit``; above 1 a second kernel sums
    them), chunks of 80 K a slice (``cps``), chunks staged at a time
    (``piece``) and the dynamic shared memory (bytes). The launcher sizes
    the grid: ceil(N / (32 cg)) x ceil(M / (8 nt)) x ksplit."""
    variant: str
    nt: int
    cg: int
    ksplit: int
    cps: int
    piece: int
    dynamic_smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def plan(m: int, k: int, n: int, x_dtype: torch.dtype) -> Plan:
    """The launch for an (m, k) x (k, n) product against 3-bit words:
    the ``decode`` kernel for m <= 16, the ``prefill`` kernel above. Tiles
    of 8 or 16 rows of x (m < 256) read their B fragments straight from x;
    tiles of 64 rows (m >= 256) stage x in shared memory, a slice of K
    whole where it fits in 96 KB, else in pieces, so each W chunk loaded
    serves 64 rows. K is split across blocks (a second kernel sums the
    slices) only as far as it must be: for 64-row tiles until the grid
    holds a block for each SM; for the others until at least 48 blocks
    stream W and no warp walks more than 4 chunks. Among the plans with the
    fewest slices the widest column group wins, so x serves as many
    columns as it can. Cached: the engine asks for the same few shapes on
    every tick."""
    decode = m <= _DECODE_MAX_M
    nt = 1 if m <= 8 else 2 if m < _STAGE_MIN_M else 8
    planes = 3 if x_dtype == torch.float32 else 1
    nch = _cdiv(_cdiv(max(k, 1), FIELDS), _CHUNK_WORDS)
    groups, row_tiles = _cdiv(max(n, 1), 32), _cdiv(max(m, 1), 8 * nt)
    best = None
    for ks in range(1, min(_MAX_KSPLIT, nch) + 1):
        ks = _cdiv(nch, _cdiv(nch, ks))          # no slice without chunks
        for cg in (8, 4, 2, 1):
            blocks = _cdiv(groups, cg) * row_tiles * ks
            if nt == 8:
                ok = blocks >= _TARGET_BLOCKS
            else:                    # short walks over K, enough SMs
                ok = (blocks >= _MIN_BLOCKS and _cdiv(_cdiv(nch, ks),
                                                      _WARPS // cg)
                      <= _MAX_WALK)
            if best is None or blocks > best[2] or ok:
                best = (cg, ks, blocks)
            if ok:
                break
        if ok:
            break
    cg, ks, _ = best
    cps = _cdiv(nch, ks)
    red_bytes = _WARPS * 32 * 2 * nt * 4 * 4
    variant = "decode" if decode else "prefill"
    if nt <= 2:                      # B fragments come straight from x
        return Plan(variant, nt, cg, ks, cps, cps, red_bytes)
    per_chunk = planes * 8 * nt * 2 * _CHUNK_K
    piece = max(1, min(cps, _X_STAGE_BYTES // per_chunk))
    x_bytes = planes * 8 * nt * (piece * _CHUNK_K + _XPAD) * 2
    return Plan("prefill", nt, cg, ks, cps, piece, max(x_bytes, red_bytes))


def x_planes(x: torch.Tensor) -> list:
    """x as the bf16 planes the kernel multiplies: bf16 x itself; fp32 x as
    hi, mid, lo, each the bf16 rounding of what the ones before leave
    (hi + mid + lo == x exactly)."""
    if x.dtype == torch.bfloat16:
        return [x]
    rest, planes = x.float(), []
    for _ in range(3):
        p = rest.to(torch.bfloat16)
        planes.append(p)
        rest = rest - p.float()
    return planes


def _level_pair(wb: torch.Tensor, f: int) -> torch.Tensor:
    """The kernel's ``level_pair``: fields 2f and 2f + 1 of a biased word
    (word ^ 0x24924924, field = level + 4) as bf16, by 128 + field minus
    132. Returns (..., 2) levels."""
    lo = (wb >> (6 * f)) & 7
    hi = (wb >> (6 * f + 3)) & 7
    v = torch.stack([lo, hi], -1).to(torch.int16) | 0x4300
    return v.view(torch.bfloat16) - torch.tensor(132.0, dtype=torch.bfloat16)


def fragment_product(x: torch.Tensor, words: torch.Tensor,
                     k: int) -> torch.Tensor:
    """x (M, K) . unpack3(words (ceil(K/10), N)) summed the way the kernel
    feeds the tensor cores, in float64: per chunk of 8 word rows, lane t of
    a quad takes word rows 2t and 2t + 1 and, at k16 step s, A-fragment
    slots {2t, 2t+1} from field pair 2s and {2t+8, 2t+9} from pair 2s + 1
    (pair p: fields 2 (p % 5), +1 of word row 2t + p // 5), against
    x[m][80 c + 20 t + 4 s + slot] of each bf16 plane of x. Equal to the
    plain product exactly wherever float64 holds it."""
    m, n = x.shape[0], words.shape[1]
    kp = words.shape[0]
    nch = _cdiv(kp, _CHUNK_WORDS)
    wpad = torch.zeros((nch * _CHUNK_WORDS, n), dtype=torch.int64)
    wpad[:kp] = words.to(torch.int64) & 0xFFFFFFFF
    wb = (wpad ^ _BIAS4).reshape(nch, 4, 2, n)            # (c, t, j, N)
    out = torch.zeros((m, n), dtype=torch.float64)
    for plane in x_planes(x):
        xp = torch.zeros((m, nch * _CHUNK_K), dtype=torch.float64)
        xp[:, :k] = plane.double()
        xp = xp.reshape(m, nch, 4, 20)                    # (M, c, t, i)
        for s in range(5):
            for half, p in enumerate((2 * s, 2 * s + 1)):
                lv = _level_pair(wb[:, :, p // 5], p % 5).double()
                for e in range(2):                        # slot 2 half + e
                    xs = xp[..., 4 * s + 2 * half + e]    # (M, c, t)
                    out += torch.einsum("mct,ctn->mn", xs, lv[..., e])
    return out


def qmatvec_cuda(x: torch.Tensor, w_packed: torch.Tensor, delta: torch.Tensor,
                 bias: torch.Tensor | None = None,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x (M, K) fp32/bf16, w_packed (ceil(K/10), N) int32, delta (N,) fp32,
    bias (N,) fp32 or None -> (M, N) in ``out_dtype`` (default x's)."""
    global launches
    if not x.is_cuda or x.dim() != 2:
        raise ValueError(f"qmatvec x: need a 2-D CUDA tensor, got "
                         f"{tuple(x.shape)} on {x.device}")
    dev = x.device
    m, k = x.shape
    kp, n = -(-k // FIELDS), w_packed.shape[-1]
    _build.require(x, (m, k), _FLOATS, dev, "qmatvec x")
    _build.require(w_packed, (kp, n), (torch.int32,), dev, "qmatvec w_packed")
    _build.require(delta, (n,), (torch.float32,), dev, "qmatvec delta")
    if bias is not None:
        _build.require(bias, (n,), (torch.float32,), dev, "qmatvec bias")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _FLOATS:
        raise TypeError(f"qmatvec output must be fp32/bf16, got {out_dtype}")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    p = plan(m, k, n, x.dtype)
    part = (torch.empty((p.ksplit, m, n), dtype=torch.float32, device=dev)
            if p.ksplit > 1 else None)
    with torch.cuda.device(dev):
        rc = _build.function("qmatvec", _ARGTYPES)(
            x.data_ptr(), w_packed.data_ptr(), delta.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), m, k, kp, n, _build.dtype_code(x.dtype),
            _build.dtype_code(out_dtype), VARIANTS.index(p.variant), p.nt,
            p.cg, p.ksplit, p.cps, p.piece, p.dynamic_smem,
            _build.stream_ptr(dev))
    _build.check(rc, f"qmatvec ({p.variant})")
    launches += 1
    launches_by_variant[p.variant] += 1
    return out
