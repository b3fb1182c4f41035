"""Quantization-aware retraining (the paper's §2.1, step 3).

Port of the reference's ``core/qat.py``. The paper retrains with fixed-point
weights in the forward path while the backward pass updates a float master
copy — the straight-through estimator (STE):

    forward:   w_q = delta * clip(round(w / delta), -M, M)
    backward:  dL/dw = dL/dw_q          (identity through the rounding)

``fake_quant`` takes a fixed ``delta`` (frozen after the quantization step)
or, with ``delta=None``, refits the L2-optimal delta in every forward pass
(outside the graph). ``fake_quant_act`` quantizes the 8-bit signals between
layers with a dynamic per-row absmax scale and the same STE.

Gradients are the reference's to the bit: the clip is written as
``minimum(maximum(q, lo), hi)``, whose backward passes half the gradient at
a bound (``jnp.clip`` does; ``torch.clamp`` would pass all of it), and
``round`` is ``x + (round(x) - x).detach()``, the reference's expression.

``three_step_pipeline`` pins the order of the paper's recipe:
float training -> optimal uniform quantization -> STE retraining.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import quantizer as qz

__all__ = ["fake_quant", "fake_quant_act", "ste_round", "ThreeStepResult",
           "three_step_pipeline"]


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round(x) (half to even) with identity gradient."""
    return x + (torch.round(x) - x).detach()


def _clip(q: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """clip with the reference's gradient: half of it at a bound."""
    return torch.minimum(torch.maximum(q, q.new_full((), lo)),
                         q.new_full((), hi))


def fake_quant(w: torch.Tensor, spec: qz.QuantSpec,
               delta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """STE fake-quantized view of ``w`` (same dtype and shape as ``w``).
    ``delta=None`` refits the L2-optimal delta; it carries no gradient."""
    if delta is None:
        with torch.no_grad():
            delta = qz.optimal_uniform_delta(w, spec)
    d = qz._broadcast_delta(torch.as_tensor(delta, device=w.device), w.shape,
                            spec.per_channel)
    d = torch.maximum(d, d.new_full((), 1e-12))
    m = float(spec.levels)
    q = _clip(ste_round(w.to(torch.float32) / d), -m, m)
    return (q * d).to(w.dtype)


def fake_quant_act(x: torch.Tensor, bits: int = 8, signed: bool = True) -> torch.Tensor:
    """Activation fake-quant with a dynamic PER-ROW absmax scale: for ``x``
    with ndim >= 2 one scale per leading row, reduced over every other
    axis (serving slots stay independent); 1-D inputs use one scale.
    ``signed=False`` quantizes to 0..2^b-1 (post-sigmoid signals)."""
    xf = x.to(torch.float32)
    dims = tuple(range(1, xf.dim())) if xf.dim() >= 2 else None

    def _reduce(t):
        return t.amax(dim=dims, keepdim=True) if dims else t.max()

    with torch.no_grad():
        if signed:
            m = float(2 ** (bits - 1) - 1)
            scale = _reduce(xf.abs())
        else:
            m = float(2 ** bits - 1)
            scale = _reduce(xf)
        scale = torch.maximum(scale / m, scale.new_full((), 1e-12))
    q = _clip(ste_round(xf / scale), -m if signed else 0.0, m)
    return (q * scale).to(x.dtype)


class ThreeStepResult(NamedTuple):
    float_params: dict
    quant_params: dict          # float master copy after retraining
    deltas: dict                # per-leaf deltas frozen after step 2
    float_metrics: dict
    retrain_metrics: dict


def three_step_pipeline(
    init_params: dict,
    float_train_fn: Callable[[dict], tuple],
    quantize_tree_fn: Callable[[dict], dict],
    retrain_fn: Callable[[dict, dict], tuple],
) -> ThreeStepResult:
    """Drive the paper's float-train -> quantize -> retrain recipe; the
    callables own the model and optimizer:

      float_train_fn(params)            -> (params, metrics)
      quantize_tree_fn(params)          -> deltas tree (step-2 L2-optimal fit)
      retrain_fn(params, deltas)        -> (params, metrics)   # STE forward
    """
    fparams, fmetrics = float_train_fn(init_params)
    deltas = quantize_tree_fn(fparams)
    qparams, qmetrics = retrain_fn(fparams, deltas)
    return ThreeStepResult(fparams, qparams, deltas, fmetrics, qmetrics)
