"""Public wrapper of the PLAN sigmoid (the activation of the paper's DNN
under ``sigmoid_mode="pw"``).

Dispatches on the tensor's device: a CPU tensor runs the plain version
(``ref.sigmoid_pw``), a CUDA tensor an autograd function whose forward and
backward are the two hand-written kernels (``kernel.sigmoid_pw_cuda``,
``kernel.sigmoid_pw_bwd_cuda``), which raise rather than fall back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sigmoid_pw import kernel, ref

__all__ = ["sigmoid_pw"]


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
