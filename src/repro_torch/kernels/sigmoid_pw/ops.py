"""Public wrappers of the PLAN sigmoid (the activation of the paper's DNN
under ``sigmoid_mode="pw"``).

Each dispatches on the tensor's device: a CPU tensor runs the plain version
(``ref.sigmoid_pw``, ``ref.sigmoid_pw_signal``); a CUDA tensor runs the
hand-written kernels, which raise rather than fall back.
``sigmoid_pw`` is an autograd function whose forward and backward are the
elementwise kernels (``kernel.sigmoid_pw_cuda``,
``kernel.sigmoid_pw_bwd_cuda``); ``sigmoid_pw_signal`` is the signal route
(``kernel.sigmoid_pw_signal_cuda``), the sigmoid and the per-row 8-bit
signal in one launch, for forwards that record no gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sigmoid_pw import kernel, ref

__all__ = ["sigmoid_pw", "sigmoid_pw_signal"]


class _SigmoidPW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return kernel.sigmoid_pw_cuda(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return kernel.sigmoid_pw_bwd_cuda(x, g.to(x.dtype))


def sigmoid_pw(x: torch.Tensor) -> torch.Tensor:
    """PLAN sigmoid of ``x`` (any shape, fp32/bf16), in x's dtype."""
    if x.device.type == "cpu":
        return ref.sigmoid_pw(x)
    if x.is_cuda:
        return _SigmoidPW.apply(x)
    raise ValueError(f"sigmoid_pw: no path for device {x.device}")


def sigmoid_pw_signal(x: torch.Tensor, bits: int) -> torch.Tensor:
    """``qat.fake_quant_act(sigmoid_pw(x), bits, signed=False)`` bit for bit
    (one scale per leading row), in x's dtype, as one stage. It carries no
    gradient: a forward that records one makes the two calls."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("sigmoid_pw_signal carries no gradient: call "
                         "sigmoid_pw, then qat.fake_quant_act")
    if x.device.type == "cpu":
        return ref.sigmoid_pw_signal(x, bits)
    if x.is_cuda:
        return kernel.sigmoid_pw_signal_cuda(x, bits)
    raise ValueError(f"sigmoid_pw_signal: no path for device {x.device}")
