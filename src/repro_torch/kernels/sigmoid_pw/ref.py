"""Plain PyTorch version of the piecewise-linear (PLAN) sigmoid (the
reference's ``sigmoid_pw/ref.py``): the CPU path of ``ops.sigmoid_pw`` and
the oracle the CUDA kernel is held against. ``calls`` counts its uses.

    y(|x|) = 1                      |x| >= 5
           = 0.03125|x| + 0.84375   2.375 <= |x| < 5
           = 0.125 |x| + 0.625      1     <= |x| < 2.375
           = 0.25  |x| + 0.5        0     <= |x| < 1
    y(-x)  = 1 - y(x)

Computed in fp32, one cast to x's dtype. The slopes are powers of two, so
every product is exact and the result is bit-identical to the reference's
in fp32 and bf16. The gradient is explicit, ``g * slope(|x|)`` with the
same ``>=`` breaks (0 where |x| >= 5), which is JAX's gradient of the
oracle: autograd through ``torch.abs`` would give 0 at x = 0, where JAX's
``abs`` passes +1.

``sigmoid_pw_signal`` is the plain version of the signal route: the PLAN
sigmoid followed by the paper's unsigned ``bits``-bit signal with one
dynamic scale per leading row, ``qat.fake_quant_act(sigmoid_pw(x), bits,
signed=False)`` written out without its straight-through round (exactly
``round`` here) and with every division a tensor division, so that it
gives the CPU's IEEE quotients on the card too (PyTorch's CUDA division by
a Python number multiplies by the reciprocal).
"""
from __future__ import annotations

import torch

__all__ = ["sigmoid_pw", "sigmoid_pw_fwd", "sigmoid_pw_bwd",
           "sigmoid_pw_signal", "calls"]

calls = 0


def sigmoid_pw_fwd(x: torch.Tensor) -> torch.Tensor:
    """The forward arithmetic, no gradient."""
    xf = x.to(torch.float32).abs()
    y = torch.where(
        xf >= 5.0, 1.0,
        torch.where(xf >= 2.375, 0.03125 * xf + 0.84375,
                    torch.where(xf >= 1.0, 0.125 * xf + 0.625,
                                0.25 * xf + 0.5)))
    y = torch.where(x < 0, 1.0 - y, y)
    return y.to(x.dtype)


def sigmoid_pw_bwd(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """d sigmoid_pw(x) / dx times ``g``: ``g * slope(|x|)`` in fp32, one
    cast to x's dtype; exactly +0 where |x| >= 5, as JAX's ``where``
    transposes give it."""
    xf = x.to(torch.float32).abs()
    slope = torch.where(xf >= 2.375, 0.03125,
                        torch.where(xf >= 1.0, 0.125, 0.25))
    gx = torch.where(xf >= 5.0, 0.0, g.to(torch.float32) * slope)
    return gx.to(x.dtype)


class _PlainSigmoidPW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return sigmoid_pw_fwd(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return sigmoid_pw_bwd(x, g)


def sigmoid_pw(x: torch.Tensor) -> torch.Tensor:
    """PLAN sigmoid of ``x`` (any shape, fp32/bf16), in x's dtype."""
    global calls
    calls += 1
    return _PlainSigmoidPW.apply(x)


def sigmoid_pw_signal(x: torch.Tensor, bits: int) -> torch.Tensor:
    """The ``bits``-bit unsigned signal of ``sigmoid_pw(x)`` with one scale
    per leading row (one for the whole of a 0-/1-D ``x``), in x's dtype:

        y = float(sigmoid_pw(x));  s = max(rowmax(y) / (2^bits - 1), 1e-12)
        out = clip(round_half_even(y / s), 0, 2^bits - 1) * s

    A NaN in a row makes the whole row NaN (amax and maximum propagate it).
    No gradient: the training forward keeps the two-call chain."""
    global calls
    calls += 1
    if x.numel() == 0:
        return torch.empty_like(x)
    m = x.shape[0] if x.dim() >= 2 else 1
    y = sigmoid_pw_fwd(x).to(torch.float32).reshape(m, -1)
    levels = y.new_full((), float(2 ** bits - 1))
    s = torch.maximum(y.amax(dim=1, keepdim=True) / levels,
                      y.new_full((), 1e-12))
    q = torch.minimum(torch.maximum(torch.round(y / s), y.new_zeros(())),
                      levels)
    return (q * s).reshape(x.shape).to(x.dtype)
