"""CUDA launch wrappers of the PLAN sigmoid (``csrc/sigmoid_pw.cu``): the
forward ``y = sigmoid_pw(x)``, the backward ``gx = g * slope(x)`` and the
signal route ``sigmoid_pw_signal(x, bits)``, the paper MLP's activation
stage: the sigmoid and the per-row ``bits``-bit signal in one launch.

Each takes a tensor already on the card, makes it contiguous and calls its
registered op (``torch.ops.repro_torch.sigmoid_pw`` / ``sigmoid_pw_bwd`` /
``sigmoid_pw_signal``, ``kernels/_ops.py``), whose CUDA implementation
allocates the output with ``torch.empty`` and launches on the current
stream. ``launches`` counts forward launches of either route,
``launches_by_variant`` splits them into ``"plain"`` (the elementwise
sigmoid) and ``"signal"``, and ``bwd_launches`` counts backward ones;
nothing else touches them.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, _ops

__all__ = ["sigmoid_pw_cuda", "sigmoid_pw_bwd_cuda",
           "sigmoid_pw_signal_cuda", "signal_plan", "SignalPlan", "launches",
           "launches_by_variant", "bwd_launches"]

launches = 0
launches_by_variant = {"plain": 0, "signal": 0}
bwd_launches = 0

_FWD_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_void_p]
_SIGNAL_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
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


class SignalPlan(NamedTuple):
    """The signal route's launch (``csrc/sigmoid_pw.cu::signal_by_width``):
    ``vec`` elements a load (16 bytes, or 1 where a pointer is off 16
    bytes), ``group`` threads a row, ``held`` vectors a thread kept in
    registers (0: the row is streamed twice), ``rows`` a block, ``grid``."""
    vec: int
    group: int
    held: int
    rows: int
    grid: int


def signal_plan(m: int, n: int, dtype, aligned: bool = True) -> SignalPlan:
    """The launch the signal route makes for x (m, n) of ``dtype``: the
    fewest threads a row whose vectors cover the row's window of whole
    vectors (a row starts a multiple of gcd(n, vec) into a vector, so at
    most ceil((n + vec - gcd) / vec) of them), then more vectors a thread,
    up to 8; beyond, the streamed kernel."""
    vec = (4 if dtype == torch.float32 else 8) if aligned else 1
    w = -(-(n + vec - math.gcd(n, vec)) // vec)
    group, held = 256, 0
    for g, h in ((32, 1), (64, 1), (128, 1), (256, 1), (256, 2), (256, 4),
                 (256, 8)):
        if w <= g * h:
            group, held = g, h
            break
    rows = _THREADS // group
    return SignalPlan(vec, group, held, rows, max(1, -(-m // rows)))


def _rows(x: torch.Tensor):
    """(M, N) of the signal: one row a leading index for ndim >= 2 (the
    scale is per row over every other axis), one row otherwise."""
    m = x.shape[0] if x.dim() >= 2 else 1
    return m, (x.numel() // m if m else 0)


def sigmoid_pw_signal_cuda(x: torch.Tensor, bits: int) -> torch.Tensor:
    """x (M, ...) fp32/bf16 on the card -> the ``bits``-bit unsigned signal
    of its PLAN sigmoid with one scale per leading row, in x's dtype:
    ``qat.fake_quant_act(sigmoid_pw(x), bits, signed=False)`` in one launch,
    through the registered op ``torch.ops.repro_torch.sigmoid_pw_signal``."""
    _check_input(x, "sigmoid_pw_signal x")
    if not 1 <= int(bits) <= 24:
        raise ValueError(f"sigmoid_pw_signal: bits must be 1..24, got {bits}")
    return _ops.op("sigmoid_pw_signal")(x.contiguous(), int(bits))


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
    launches_by_variant["plain"] += 1
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


def _alloc_signal(x: torch.Tensor, aligned: bool = True) -> torch.Tensor:
    """The signal route's output, its plan noted for a recording (a fake
    tensor has no address: planned as a 16-byte aligned one)."""
    y = torch.empty_like(x)
    if x.numel():
        m, n = _rows(x)
        p = signal_plan(m, n, x.dtype, aligned)
        _ops.note("sigmoid_pw", "signal", (p.grid,), 0, plan=p)
    return y


def _launch_signal(x, bits):
    """The signal op's CUDA implementation."""
    global launches
    y = _alloc_signal(x, x.data_ptr() % 16 == 0)
    if x.numel() == 0:
        return y
    m, n = _rows(x)
    with torch.cuda.device(x.device):
        rc = _build.function("sigmoid_pw", _SIGNAL_ARGTYPES,
                             entry="sigmoid_pw_signal")(
            x.data_ptr(), y.data_ptr(), m, n, float(2 ** bits - 1),
            _build.dtype_code(x.dtype), _build.stream_ptr(x.device))
    _build.check(rc, "sigmoid_pw_signal")
    launches += 1
    launches_by_variant["signal"] += 1
    return y


_ops.define("sigmoid_pw", "(Tensor x) -> Tensor", _launch_fwd,
            lambda x: _alloc("sigmoid_pw", x))
_ops.define("sigmoid_pw_bwd", "(Tensor x, Tensor g) -> Tensor", _launch_bwd,
            lambda x, g: _alloc("sigmoid_pw_bwd", x))
_ops.define("sigmoid_pw_signal", "(Tensor x, int bits) -> Tensor",
            _launch_signal, lambda x, bits: _alloc_signal(x))
