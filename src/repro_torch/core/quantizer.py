"""Optimal uniform weight quantization (the paper's §2.1, step 2).

Port of the reference's ``core/quantizer.py``: for float weights ``w`` and
the symmetric level set ``{-M, ..., +M}`` (M = 2^(bits-1) - 1) find the step
``delta`` minimising ``|| w - delta * q ||_2^2`` with
``q = clip(round(w / delta), -M, M)`` by alternating the exact assignment
and 1-D least-squares steps for ``spec.iters`` iterations.

The reference vmaps a per-vector loop over channels; here one loop runs on
a (C, N) matrix and every channel's delta updates at once. ``torch.round``
is half-to-even, like ``jnp.round``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["QuantSpec", "max_level", "optimal_uniform_delta",
           "quantize_levels", "dequantize", "quantize", "quantization_mse"]


def max_level(bits: int) -> int:
    """Largest integer level for a symmetric ``bits``-bit quantizer
    (3 bits -> 3, 8 bits -> 127, 2 bits -> 1)."""
    if bits < 2:
        raise ValueError(f"need >= 2 bits for a symmetric signed quantizer, got {bits}")
    return 2 ** (bits - 1) - 1


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """How one tensor is quantized: ``bits``; ``per_channel`` axis (None =
    per-tensor, the paper's choice); ``iters`` alternating steps."""

    bits: int = 3
    per_channel: Optional[int] = None
    iters: int = 25

    @property
    def levels(self) -> int:
        return max_level(self.bits)


def _optimal_delta_rows(w: torch.Tensor, m: int, iters: int) -> torch.Tensor:
    """Alternating minimisation on every row of a (C, N) matrix at once.
    Returns (C,) fp32 deltas."""
    w = w.to(torch.float32)
    amax = w.abs().amax(dim=1)
    delta = torch.where(amax > 0, amax / m, torch.ones_like(amax))
    for _ in range(iters):
        q = torch.clamp(torch.round(w / torch.clamp(delta, min=1e-12)[:, None]),
                        -m, m)
        num = (w * q).sum(dim=1)
        den = (q * q).sum(dim=1)
        new = torch.where(den > 0, num / torch.clamp(den, min=1e-12),
                          torch.zeros_like(num))
        # guard against a degenerate all-zero assignment collapsing delta
        delta = torch.where(new > 0, new, delta)
    return delta


def optimal_uniform_delta(w: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """L2-optimal uniform step size(s): a 0-d tensor (per-tensor) or a
    vector of shape ``(w.shape[axis],)`` (per-channel)."""
    m = spec.levels
    if spec.per_channel is None:
        return _optimal_delta_rows(w.reshape(1, -1), m, spec.iters)[0]
    axis = spec.per_channel % w.dim()
    wc = torch.movedim(w, axis, 0).reshape(w.shape[axis], -1)
    return _optimal_delta_rows(wc, m, spec.iters)


def _broadcast_delta(delta: torch.Tensor, w_shape, axis: Optional[int]) -> torch.Tensor:
    if axis is None:
        return delta
    axis = axis % len(w_shape)
    shape = [1] * len(w_shape)
    shape[axis] = w_shape[axis]
    return delta.reshape(shape)


def quantize_levels(w: torch.Tensor, delta: torch.Tensor,
                    spec: QuantSpec) -> torch.Tensor:
    """Integer levels q = clip(round(w/delta), -M, M), int8 dtype."""
    d = _broadcast_delta(delta, w.shape, spec.per_channel)
    q = torch.clamp(torch.round(w / torch.clamp(d, min=1e-12)),
                    -spec.levels, spec.levels)
    return q.to(torch.int8)


def dequantize(q: torch.Tensor, delta: torch.Tensor, spec: QuantSpec,
               dtype=torch.float32) -> torch.Tensor:
    d = _broadcast_delta(torch.as_tensor(delta, device=q.device), q.shape,
                         spec.per_channel)
    return (q.to(torch.float32) * d).to(dtype)


def quantize(w: torch.Tensor, spec: QuantSpec):
    """Full pipeline: fit delta, assign levels. Returns (q_int8, delta)."""
    delta = optimal_uniform_delta(w, spec)
    return quantize_levels(w, delta, spec), delta


def quantization_mse(w: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Mean squared quantization error of the L2-optimal quantizer on ``w``."""
    q, delta = quantize(w, spec)
    return torch.mean((w - dequantize(q, delta, spec, w.dtype)) ** 2)
