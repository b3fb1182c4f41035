"""CUDA launch wrapper of the packed-container matmul (``csrc/qmatvec.cu``).

Takes 2-D operands already on the card, checks everything the kernel does
not handle itself, allocates the output and launches on the current stream.
``launches`` counts launches; nothing else touches it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["qmatvec_cuda", "launches", "FIELDS"]

FIELDS = 10                    # 3-bit fields per int32 container word
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_FLOATS = (torch.float32, torch.bfloat16)


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
    with torch.cuda.device(dev):
        rc = _build.function("qmatvec", _ARGTYPES)(
            x.data_ptr(), w_packed.data_ptr(), delta.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            m, k, kp, n, _build.dtype_code(x.dtype),
            _build.dtype_code(out_dtype), _build.stream_ptr(dev))
    _build.check(rc, "qmatvec")
    launches += 1
    return out
