"""CUDA launch wrappers of the PLAN sigmoid (``csrc/sigmoid_pw.cu``): the
forward ``y = sigmoid_pw(x)`` and the backward ``gx = g * slope(x)``.

Each takes a tensor already on the card, makes it contiguous and calls its
registered op (``torch.ops.repro_torch.sigmoid_pw`` / ``sigmoid_pw_bwd``,
``kernels/_ops.py``), whose CUDA implementation allocates the output with
``torch.empty`` and launches on the current stream.
``launches`` counts forward launches and ``bwd_launches`` backward ones;
nothing else touches them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _ops

__all__ = ["sigmoid_pw_cuda", "sigmoid_pw_bwd_cuda", "launches",
           "bwd_launches"]

launches = 0
bwd_launches = 0

_FWD_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_void_p]
_FLOATS = (torch.float32, torch.bfloat16)
_THREADS, _MAX_BLOCKS = 256, 132 * 32      # as csrc/sigmoid_pw.cu


def _check_input(x: torch.Tensor, what: str) -> None:
    if not x.is_cuda or x.dtype not in _FLOATS:
        raise ValueError(f"{what}: need a fp32/bf16 CUDA tensor, got "
                         f"{x.dtype} on {x.device}")


def sigmoid_pw_cuda(x: torch.Tensor) -> torch.Tensor:
    """x (any shape) fp32/bf16 on the card -> PLAN sigmoid, x's dtype,
    through the registered op ``torch.ops.repro_torch.sigmoid_pw``."""
    _check_input(x, "sigmoid_pw x")
    return _ops.op("sigmoid_pw")(x.contiguous())


def sigmoid_pw_bwd_cuda(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x and the output gradient g (same shape and dtype, on the card) ->
    g * slope(x), in x's dtype, through the registered op
    ``torch.ops.repro_torch.sigmoid_pw_bwd``."""
    _check_input(x, "sigmoid_pw_bwd x")
    if g.device != x.device or g.dtype != x.dtype or g.shape != x.shape:
        raise ValueError(f"sigmoid_pw_bwd g: need {tuple(x.shape)} {x.dtype} "
                         f"on {x.device}, got {tuple(g.shape)} {g.dtype} on "
                         f"{g.device}")
    return _ops.op("sigmoid_pw_bwd")(x.contiguous(), g.contiguous())


def _alloc(kernel: str, x: torch.Tensor) -> torch.Tensor:
    """The launch's output, its grid (16-byte vectors, as for aligned
    pointers) noted for a recording; shared by both implementations."""
    y = torch.empty_like(x)
    if x.numel():
        vec = 4 if x.dtype == torch.float32 else 8
        n = x.numel()
        rest = n - n // vec * vec
        blocks = min(_MAX_BLOCKS, -(-(n // vec + rest) // _THREADS))
        _ops.note(kernel, "", (max(blocks, 1),), 0)
    return y


def _launch_fwd(x):
    """The forward op's CUDA implementation."""
    global launches
    y = _alloc("sigmoid_pw", x)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        rc = _build.function("sigmoid_pw", _FWD_ARGTYPES)(
            x.data_ptr(), y.data_ptr(), x.numel(),
            _build.dtype_code(x.dtype), _build.stream_ptr(x.device))
    _build.check(rc, "sigmoid_pw")
    launches += 1
    return y


def _launch_bwd(x, g):
    """The backward op's CUDA implementation."""
    global bwd_launches
    gx = _alloc("sigmoid_pw_bwd", x)
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


_ops.define("sigmoid_pw", "(Tensor x) -> Tensor", _launch_fwd,
            lambda x: _alloc("sigmoid_pw", x))
_ops.define("sigmoid_pw_bwd", "(Tensor x, Tensor g) -> Tensor", _launch_bwd,
            lambda x, g: _alloc("sigmoid_pw_bwd", x))
