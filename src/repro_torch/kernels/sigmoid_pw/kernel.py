"""CUDA launch wrappers of the PLAN sigmoid (``csrc/sigmoid_pw.cu``): the
forward ``y = sigmoid_pw(x)`` and the backward ``gx = g * slope(x)``.

Each takes a tensor already on the card, makes it contiguous, allocates the
output with ``torch.empty`` and launches on the current stream.
``launches`` counts forward launches and ``bwd_launches`` backward ones;
nothing else touches them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["sigmoid_pw_cuda", "sigmoid_pw_bwd_cuda", "launches",
           "bwd_launches"]

launches = 0
bwd_launches = 0

_FWD_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_void_p]
_FLOATS = (torch.float32, torch.bfloat16)


def _check_input(x: torch.Tensor, what: str) -> None:
    if not x.is_cuda or x.dtype not in _FLOATS:
        raise ValueError(f"{what}: need a fp32/bf16 CUDA tensor, got "
                         f"{x.dtype} on {x.device}")


def sigmoid_pw_cuda(x: torch.Tensor) -> torch.Tensor:
    """x (any shape) fp32/bf16 on the card -> PLAN sigmoid, x's dtype."""
    global launches
    _check_input(x, "sigmoid_pw x")
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        rc = _build.function("sigmoid_pw", _FWD_ARGTYPES)(
            x.data_ptr(), y.data_ptr(), x.numel(),
            _build.dtype_code(x.dtype), _build.stream_ptr(x.device))
    _build.check(rc, "sigmoid_pw")
    launches += 1
    return y


def sigmoid_pw_bwd_cuda(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x and the output gradient g (same shape and dtype, on the card) ->
    g * slope(x), in x's dtype."""
    global bwd_launches
    _check_input(x, "sigmoid_pw_bwd x")
    if g.device != x.device or g.dtype != x.dtype or g.shape != x.shape:
        raise ValueError(f"sigmoid_pw_bwd g: need {tuple(x.shape)} {x.dtype} "
                         f"on {x.device}, got {tuple(g.shape)} {g.dtype} on "
                         f"{g.device}")
    x, g = x.contiguous(), g.contiguous()
    gx = torch.empty_like(x)
    if x.numel() == 0:
        return gx
    with torch.cuda.device(x.device):
        rc = _build.function("sigmoid_pw", _BWD_ARGTYPES,
                             entry="sigmoid_pw_bwd")(
            x.data_ptr(), g.data_ptr(), gx.data_ptr(), x.numel(),
            _build.dtype_code(x.dtype), _build.stream_ptr(x.device))
    _build.check(rc, "sigmoid_pw_bwd")
    bwd_launches += 1
    return gx
