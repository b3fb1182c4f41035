"""CUDA launch wrapper of the int8-level matmul (``csrc/qmatmul.cu``).

W is passed by pointer and element strides, so a transposed view (the tied
readout's ``q.T``) is read in place, never copied. :func:`plan` picks the
kernel's layout from the strides and N (pure Python, so the CPU tests reach
it): ``k_lanes`` (lanes along K) for a K-contiguous W (the readout) and for
a row-major W of at most 64 columns (the paper MLP's heads and the MoE
routers: tiles of rows on the tensor cores, K split across the blocks of a
cluster where the tiles are few), ``n_lanes``
(lanes along N) for any other (the ``q`` form's projections), and for
``n_lanes`` its variant by M, ``decode`` (M <= 16) or ``prefill``, and its
split of K. ``launches`` counts launches (one a call, a K split's second
kernel included), ``launches_by_layout`` splits them by layout,
``launches_by_variant`` the ``n_lanes`` ones by variant and
``launches_by_orientation`` the ``k_lanes`` ones by W's orientation
(``k_major``: the readout and the container head; ``row_major``: the MLP
heads and the MoE router); nothing else touches them. The launch is the
CUDA implementation of the registered op ``torch.ops.repro_torch.qmatmul``
(``kernels/_ops.py``), whose fake implementation allocates the same
output and K-split partials.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, _ops

__all__ = ["qmatmul_cuda", "plan", "Plan", "launches", "launches_by_layout",
           "launches_by_variant", "launches_by_orientation", "LAYOUTS",
           "N_LANES_VARIANTS", "K_LANES_ORIENTATIONS", "decode_tile_row"]

LAYOUTS = ("n_lanes", "k_lanes")
N_LANES_VARIANTS = ("decode", "prefill")
K_LANES_ORIENTATIONS = ("k_major", "row_major")
launches = 0
launches_by_layout = dict.fromkeys(LAYOUTS, 0)
launches_by_variant = dict.fromkeys(N_LANES_VARIANTS, 0)   # n_lanes only
launches_by_orientation = dict.fromkeys(K_LANES_ORIENTATIONS, 0)  # k_lanes

# k_lanes, K-contiguous W: 128 K values a step; x staged in K chunks of a
# multiple of the step (padded by 8 bf16 per row), in bf16 planes
_KL_STEP, _KL_PAD = 128, 8
_KL_X_BYTES = 96 * 1024      # staged x per block: leaves room for 2 blocks/SM
_KN_MAX_N = 64               # k_lanes, row-major W: N <= 64
_KL_WARPS = 8                # k_lanes, K-major: warps a block
# k_lanes, row-major W (csrc/qmatmul.cu, KrSmem): 8 warps, 64-K steps, at
# most 8 K slices (a cluster); each warp's x stages (4 stages of 4 16-byte
# slots a lane for bf16 x, 2 of 8 for fp32); W staged as int8
_KR_WARPS, _KR_SUB, _KR_MAX_CLUSTER = 8, 64, 8
_KR_WARP_X = {torch.bfloat16: 4 * 4 * 32 * 16, torch.float32: 2 * 8 * 32 * 16}
_KR_SMEM = _ops.SM_SMEM // 2 - _ops.BLOCK_RESERVED
_KR_W_CHUNK = 32 * 1024      # staged W a chunk, at most (where K allows)

# n_lanes, as csrc/qmatmul.cu: K in chunks (decode) or steps (prefill) of
# 64; decode blocks of 64 columns, each warp two int8 stages of a chunk and
# a (64, 64 + 8) bf16 tile; prefill blocks of 128 x 128 outputs, three
# cp.async stages of raw x and int8 W, a bf16 W tile (rows padded by 8)
_NL_K, _ND_COLS = 64, 64
_ND_WARP_BYTES = 2 * 64 * 64 + 64 * 72 * 2      # 2 int8 stages, a bf16 tile
_ND_TARGET_BLOCKS = 2 * 132  # decode: two blocks of 4 warps on every SM
_ND_MAX_BLOCKS = 3 * 132     # ... and no more than fit at once (one wave)
_NP_BM, _NP_BN, _NP_X_ROW, _NP_W_ROW = 128, 128, 72, 136
_NP_STAGES = 3               # prefill: cp.async stages of x and W
_DECODE_MAX_M = 16
_TARGET_BLOCKS = 132         # one block for each SM of the H100
_MAX_KSPLIT = 16
_NP_MIN_STEPS = 4            # prefill: K steps a slice, at least

_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2
             + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
_FLOATS = (torch.float32, torch.bfloat16)


class Plan(NamedTuple):
    """One launch: the layout, its two parameters, the dynamic shared
    memory it asks for (bytes), the n_lanes variant and the slices of K
    across blocks, and the k_lanes orientation of W (``k_major`` or
    ``row_major``). k_lanes with a K-contiguous W: p0 = 8-row tiles of x a
    block, p1 = K values staged a chunk; with a row-major W: p0 = 16-row
    tiles a block (row warps; the other warps of the 8 split K), p1 = K
    values of W staged a chunk. n_lanes: p0 = warps a block (decode; 0 for
    prefill), p1 = 64-K chunks a slice.
    The launcher sizes the grid: decode ceil(N / 64) x ksplit, prefill
    ceil(N / 128) x ceil(M / 128) x ksplit, row-major k_lanes
    ceil(M / (16 p0)) x ksplit."""
    layout: str
    p0: int
    p1: int
    dynamic_smem: int
    variant: str = ""
    ksplit: int = 1
    orientation: str = ""


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _slices(nch: int, ks: int) -> tuple:
    """(chunks a slice, slices) for about ``ks`` slices of ``nch`` chunks,
    none of them empty."""
    cps = _cdiv(nch, ks)
    return cps, _cdiv(nch, cps)


def _n_lanes_plan(m: int, k: int, n: int, x_dtype: torch.dtype) -> Plan:
    """decode for m <= 16: blocks of 64 columns, each with as many warps
    (1, 2 or 4) as its slice of K has chunks; K split across blocks until
    there are two blocks for each SM, short of a second wave (three blocks
    fit an SM) and of 16 slices: a warp's chunk is a latency chain, so the
    card needs warps more than bytes in flight. prefill above: 128 x 128
    tiles, K split across blocks while the grid has fewer blocks than SMs
    and every slice keeps at least 4 steps of K."""
    nch = _cdiv(max(k, 1), _NL_K)
    if m <= _DECODE_MAX_M:
        cols = _cdiv(max(n, 1), _ND_COLS)
        cps, ks = nch, 1
        for want in range(2, min(_MAX_KSPLIT, nch) + 1):
            if cols * ks >= _ND_TARGET_BLOCKS:
                break
            c, k_ = _slices(nch, want)
            if cols * k_ > _ND_MAX_BLOCKS:           # past one wave
                break
            cps, ks = c, k_
        kw = max(w for w in (1, 2, 4) if w <= cps)
        return Plan("n_lanes", kw, cps, kw * _ND_WARP_BYTES, "decode", ks)
    tiles = _cdiv(max(n, 1), _NP_BN) * _cdiv(m, _NP_BM)
    cps, ks = nch, 1
    for want in range(2, _MAX_KSPLIT + 1):
        if tiles * ks >= _TARGET_BLOCKS or _cdiv(nch, want) < _NP_MIN_STEPS:
            break
        cps, ks = _slices(nch, want)
    return Plan("n_lanes", 0, cps, _np_smem(x_dtype), "prefill", ks)


def _np_smem(x_dtype: torch.dtype) -> int:
    """n_lanes prefill's shared memory (csrc/qmatmul.cu, ``NpSmem``):
    three cp.async stages of the raw x tile (rows padded by 16 bytes) and
    the raw int8 W tile, the bf16 W tile and, for fp32 x, its three bf16
    planes."""
    fp32 = x_dtype == torch.float32
    xb = 4 if fp32 else 2
    stage = _NP_BM * (_NL_K + 16 // xb) * xb + _NL_K * _NP_BN
    return (_NP_STAGES * stage + _NL_K * _NP_W_ROW * 2
            + (3 * _NP_BM * _NP_X_ROW * 2 if fp32 else 0))


def rows_smem(nt: int, kch: int, rw: int, x_dtype: torch.dtype) -> int:
    """Row-major k_lanes' shared memory (csrc/qmatmul.cu, ``KrSmem``):
    the staged int8 W chunk, nt * 8 rows of kch bytes padded to 32 past a
    multiple of 128, and every warp's x stages; at least the cross-warp
    sum's 8 x 16 x nt * 8 fp32 and the block's rw x 16 x nt * 8 sums."""
    ld = kch + (32 - kch) % 128
    return max(nt * 8 * ld + _KR_WARPS * _KR_WARP_X[x_dtype],
               (_KR_WARPS + rw) * 16 * nt * 8 * 4)


def _rows_plan(m: int, k: int, n: int, x_dtype: torch.dtype) -> Plan:
    """Row-major k_lanes (N <= 64: the routers, the MLP heads): blocks
    of rw 16-row tiles, the largest rw (8, 4, 2) that still gives a block
    for each SM. Else one tile a block (rw = 1), its 8 warps splitting K,
    and K also split across the blocks of a cluster, up to two blocks for
    each SM, 8 slices (a portable cluster) and two 64-K steps a slice (a
    tick's M = 8 and the MLP heads: fewer blocks, each a longer chain of
    steps, measured slower). W is staged in chunks of at most 32 KB (two
    blocks an SM; mixtral's 48 KB router in two chunks measured faster
    than in one)."""
    nt = next(v for v in (1, 2, 4, 8) if 8 * v >= n)
    nsub = _cdiv(max(k, 1), _KR_SUB)
    tiles = _cdiv(max(m, 1), 16)
    rw = next((r for r in (8, 4, 2) if _cdiv(tiles, r) >= _TARGET_BLOCKS),
              1)
    ks = 1
    if rw == 1:
        ks = max(1, min(_KR_MAX_CLUSTER, nsub // 2,
                        _cdiv(2 * _TARGET_BLOCKS, tiles)))
    spz, ks = _slices(nsub, ks)
    span = spz * _KR_SUB                      # K a block walks
    room = min(_KR_W_CHUNK, _KR_SMEM - _KR_WARPS * _KR_WARP_X[x_dtype])
    chunks = 1
    while True:
        kch = _cdiv(_cdiv(span, chunks), _KR_SUB) * _KR_SUB
        if kch == _KR_SUB or nt * 8 * (kch + (32 - kch) % 128) <= room:
            break
        chunks += 1
    return Plan("k_lanes", rw, kch, rows_smem(nt, kch, rw, x_dtype),
                ksplit=ks, orientation="row_major")


@functools.lru_cache(maxsize=None)
def plan(m: int, k: int, n: int, stride_k: int, stride_n: int,
         x_dtype: torch.dtype) -> Plan:
    """The launch for an (m, k) x (k, n) product with W's element strides:
    k_lanes for a K-contiguous W (``stride_k == 1``) or a row-major W of
    ``n <= 64`` columns, n_lanes for anything else, in the variant and
    split of :func:`_n_lanes_plan`."""
    if stride_k == 1:
        planes = 3 if x_dtype == torch.float32 else 1
        nt = 1 if m <= 8 else 2 if m <= 16 else 4
        per_k = planes * 8 * nt * 2
        kc = min(_cdiv(max(k, 1), _KL_STEP) * _KL_STEP,
                 (_KL_X_BYTES // per_k - _KL_PAD) // _KL_STEP * _KL_STEP)
        return Plan("k_lanes", nt, kc, per_k * (kc + _KL_PAD),
                    orientation="k_major")
    if stride_n == 1 and n <= _KN_MAX_N:
        return _rows_plan(m, k, n, x_dtype)
    return _n_lanes_plan(m, k, n, x_dtype)


def decode_tile_row(r: int) -> int:
    """csrc/qmatmul.cu's ``nd_tile_row``: the bf16 tile row that row r of
    a 64-row chunk of W goes to in n_lanes decode. r = 16 t + 4 s + q lands
    in k16 step s at A slot 2 t + q (q < 2) or 8 + 2 t + q - 2, so lane t's
    B slots over the chunk's four steps are x[16 t .. 16 t + 16)."""
    t, s, q = r >> 4, (r >> 2) & 3, r & 3
    return 16 * s + (2 * t + q if q < 2 else 8 + 2 * t + q - 2)


def _grid(p: Plan, m: int, n: int) -> tuple:
    """The main kernel's grid as ``csrc/qmatmul.cu`` sizes it. k_lanes with
    a K-contiguous W is a persistent grid sized by the blocks an SM holds,
    which the launcher asks the CUDA runtime for; here they are estimated
    from the shared memory and the 2048 threads of an SM."""
    if p.layout == "k_lanes" and p.orientation == "row_major":
        return (_cdiv(m, 16 * p.p0), p.ksplit)
    if p.layout == "k_lanes":
        gy = _cdiv(m, 8 * p.p0)
        per_sm = max(1, min(2048 // (32 * _KL_WARPS),
                            _ops.SM_SMEM // (p.dynamic_smem
                                             + _ops.BLOCK_RESERVED)))
        tiles = _cdiv(n, 16)
        resident = max(1, _TARGET_BLOCKS * per_sm // gy)
        rounds = _cdiv(tiles, resident * _KL_WARPS)
        return (_cdiv(tiles, rounds * _KL_WARPS), gy)
    if p.variant == "decode":
        return (_cdiv(n, _ND_COLS), p.ksplit)
    return (_cdiv(n, _NP_BN), _cdiv(m, _NP_BM), p.ksplit)


def qmatmul_cuda(x: torch.Tensor, w_q: torch.Tensor, delta: torch.Tensor,
                 bias: torch.Tensor | None = None,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x (M, K) fp32/bf16, w_q (K, N) int8 of any non-negative strides,
    delta (N,) fp32, bias (N,) fp32 or None -> (M, N) in ``out_dtype``
    (default x's). Checks what the kernel does not handle, then calls the
    registered op ``torch.ops.repro_torch.qmatmul``."""
    if not x.is_cuda or x.dim() != 2:
        raise ValueError(f"qmatmul x: need a 2-D CUDA tensor, got "
                         f"{tuple(x.shape)} on {x.device}")
    dev = x.device
    m, k = x.shape
    _build.require(x, (m, k), _FLOATS, dev, "qmatmul x")
    if (w_q.device != dev or w_q.dtype != torch.int8 or w_q.dim() != 2
            or w_q.shape[0] != k or min(w_q.stride()) < 0):
        raise ValueError(f"qmatmul w_q: need a ({k}, N) int8 tensor on {dev} "
                         f"with non-negative strides, got {tuple(w_q.shape)} "
                         f"{w_q.dtype} on {w_q.device}")
    n = w_q.shape[1]
    _build.require(delta, (n,), (torch.float32,), dev, "qmatmul delta")
    if bias is not None:
        _build.require(bias, (n,), (torch.float32,), dev, "qmatmul bias")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _FLOATS:
        raise TypeError(f"qmatmul output must be fp32/bf16, got {out_dtype}")
    return _ops.op("qmatmul")(x, w_q, delta, bias, out_dtype)


def _alloc(x, w_q, out_dtype):
    """The launch's plan, its output and its K-split partials (None
    without a split), noted for a recording; shared by both
    implementations of the op."""
    m, k = x.shape
    n = w_q.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return None, out, None
    sk, sn = w_q.stride()
    p = plan(m, k, n, sk, sn, x.dtype)
    part = (torch.empty((p.ksplit, m, n), dtype=torch.float32,
                        device=x.device)
            if p.ksplit > 1 and p.layout == "n_lanes" else None)
    _ops.note("qmatmul", "/".join(v for v in (p.layout, p.variant
                                              or p.orientation)),
              _grid(p, m, n), p.dynamic_smem,
              [] if part is None else [(part.shape, part.dtype)], p)
    return p, out, part


def _launch(x, w_q, delta, bias, out_dtype):
    """The op's CUDA implementation: the launch on the current stream."""
    global launches
    p, out, part = _alloc(x, w_q, out_dtype)
    if p is None:
        return out
    dev = x.device
    m, k = x.shape
    n = w_q.shape[1]
    sk, sn = w_q.stride()
    with torch.cuda.device(dev):
        rc = _build.function("qmatmul", _ARGTYPES)(
            x.data_ptr(), w_q.data_ptr(), sk, sn, delta.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), m, k, n,
            _build.dtype_code(x.dtype), _build.dtype_code(out_dtype),
            LAYOUTS.index(p.layout),
            N_LANES_VARIANTS.index(p.variant) if p.variant else 0, p.p0,
            p.p1, p.ksplit, p.dynamic_smem, _build.stream_ptr(dev))
    _build.check(rc, f"qmatmul {p.layout} {p.variant}".strip())
    launches += 1
    launches_by_layout[p.layout] += 1
    if p.variant:
        launches_by_variant[p.variant] += 1
    else:
        launches_by_orientation[p.orientation] += 1
    return out


def _fake(x, w_q, delta, bias, out_dtype):
    """The op's fake implementation: the launch's allocations, no work."""
    return _alloc(x, w_q, out_dtype)[1]


def _flops(x, w_q, delta, bias, out_dtype, out_shape=None):
    """2 M K N."""
    return 2 * x[0] * x[1] * w_q[1]


_ops.define("qmatmul", "(Tensor x, Tensor w_q, Tensor delta, Tensor? bias, "
            "ScalarType out_dtype) -> Tensor", _launch, _fake, _flops)
