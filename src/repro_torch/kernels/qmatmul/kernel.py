"""CUDA launch wrapper of the int8-level matmul (``csrc/qmatmul.cu``).

W is passed by pointer and element strides, so a transposed view (the tied
readout's ``q.T``) is read in place, never copied. ``launches`` counts
launches; nothing else touches it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["qmatmul_cuda", "launches"]

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
_FLOATS = (torch.float32, torch.bfloat16)


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
    with torch.cuda.device(dev):
        rc = _build.function("qmatmul", _ARGTYPES)(
            x.data_ptr(), w_q.data_ptr(), sk, sn, delta.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            m, k, n, _build.dtype_code(x.dtype),
            _build.dtype_code(out_dtype), _build.stream_ptr(dev))
    _build.check(rc, "qmatmul")
    launches += 1
    return out
