"""CUDA launch wrapper of the int8-level matmul (``csrc/qmatmul.cu``).

W is passed by pointer and element strides, so a transposed view (the tied
readout's ``q.T``) is read in place, never copied. :func:`plan` picks the
kernel's layout from the strides and N (pure Python, so the CPU tests reach
it): ``k_lanes`` (lanes along K) for a K-contiguous W (the readout) and for
a row-major W of at most 64 columns (the paper MLP's heads), ``n_lanes``
(lanes along N) for any other. ``launches`` counts launches and
``launches_by_layout`` splits them by layout; nothing else touches either.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

__all__ = ["qmatmul_cuda", "plan", "Plan", "launches", "launches_by_layout",
           "LAYOUTS"]

LAYOUTS = ("n_lanes", "k_lanes")
launches = 0
launches_by_layout = dict.fromkeys(LAYOUTS, 0)

# k_lanes, K-contiguous W: 128 K values a step; x staged in K chunks of a
# multiple of the step (padded by 8 bf16 per row), in bf16 planes
_KL_STEP, _KL_PAD = 128, 8
_KL_X_BYTES = 96 * 1024      # staged x per block: leaves room for 2 blocks/SM
_KN_MAX_N = 64               # k_lanes, row-major W: N <= 64

_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
_FLOATS = (torch.float32, torch.bfloat16)


class Plan(NamedTuple):
    """One launch: the layout, its two parameters (for a K-contiguous W in
    k_lanes: 8-row tiles of x per block and K values staged per chunk;
    otherwise 0) and the dynamic shared memory it asks for (bytes). The
    launcher sizes the grid."""
    layout: str
    p0: int
    p1: int
    dynamic_smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(m: int, k: int, n: int, stride_k: int, stride_n: int,
         x_dtype: torch.dtype) -> Plan:
    """The launch for an (m, k) x (k, n) product with W's element strides:
    k_lanes for a K-contiguous W (``stride_k == 1``) or a row-major W of
    ``n <= 64`` columns, n_lanes for anything else."""
    if stride_k == 1:
        planes = 3 if x_dtype == torch.float32 else 1
        nt = 1 if m <= 8 else 2 if m <= 16 else 4
        per_k = planes * 8 * nt * 2
        kc = min(_cdiv(max(k, 1), _KL_STEP) * _KL_STEP,
                 (_KL_X_BYTES // per_k - _KL_PAD) // _KL_STEP * _KL_STEP)
        return Plan("k_lanes", nt, kc, per_k * (kc + _KL_PAD))
    if stride_n == 1 and n <= _KN_MAX_N:
        return Plan("k_lanes", 0, 0, 0)
    return Plan("n_lanes", 0, 0, 0)


def qmatmul_cuda(x: torch.Tensor, w_q: torch.Tensor, delta: torch.Tensor,
                 bias: torch.Tensor | None = None,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x (M, K) fp32/bf16, w_q (K, N) int8 of any non-negative strides,
    delta (N,) fp32, bias (N,) fp32 or None -> (M, N) in ``out_dtype``
    (default x's)."""
    global launches
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
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    sk, sn = w_q.stride()
    p = plan(m, k, n, sk, sn, x.dtype)
    with torch.cuda.device(dev):
        rc = _build.function("qmatmul", _ARGTYPES)(
            x.data_ptr(), w_q.data_ptr(), sk, sn, delta.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            m, k, n, _build.dtype_code(x.dtype), _build.dtype_code(out_dtype),
            LAYOUTS.index(p.layout), p.p0, p.p1, p.dynamic_smem,
            _build.stream_ptr(dev))
    _build.check(rc, "qmatmul")
    launches += 1
    launches_by_layout[p.layout] += 1
    return out
