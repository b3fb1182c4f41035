"""Activation fake-quant (the paper's 8-bit signals between layers).

Port of ``fake_quant_act`` from the reference's ``core/qat.py``, the part
of QAT on the serve path (W3A8 has ``act_bits=8``). STE ``fake_quant`` and
the three-step pipeline belong to training, not yet ported. Serving needs
no gradient, so the straight-through round is a plain ``torch.round``
(half-to-even, like ``jnp.round``).
"""
from __future__ import annotations

import torch

__all__ = ["fake_quant_act"]


def fake_quant_act(x: torch.Tensor, bits: int = 8, signed: bool = True) -> torch.Tensor:
    """Activation fake-quant with a dynamic PER-ROW absmax scale: for ``x``
    with ndim >= 2 one scale per leading row, reduced over every other
    axis (serving slots stay independent); 1-D inputs use one scale.
    ``signed=False`` quantizes to 0..2^b-1."""
    xf = x.to(torch.float32)
    dims = tuple(range(1, xf.dim())) if xf.dim() >= 2 else None
    keep = xf.dim() >= 2

    def _reduce(t):
        return t.amax(dim=dims, keepdim=keep) if dims else t.max()

    if signed:
        m = float(2 ** (bits - 1) - 1)
        scale = torch.clamp(_reduce(xf.abs()) / m, min=1e-12)
        q = torch.clamp(torch.round(xf / scale), -m, m)
    else:
        m = float(2 ** bits - 1)
        scale = torch.clamp(_reduce(xf) / m, min=1e-12)
        q = torch.clamp(torch.round(xf / scale), 0.0, m)
    return (q * scale).to(x.dtype)
