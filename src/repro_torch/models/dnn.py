"""The paper's feed-forward DNN (§2.1): 784-1022-1022-1022-10 (digit) and
429-1022x4-61 (phoneme), sigmoid hidden units.

Port of the reference's ``models/dnn.py``: W3 hidden layers, W8 output
layer, 8-bit signals between layers (``policy.act_bits=8``), full-precision
biases. ``sigmoid_mode`` selects the exact sigmoid or the piecewise-linear
PLAN approximation (paper ref [16]). The PLAN sigmoid goes through
``kernels.sigmoid_pw.ops``: the CUDA kernel on the card, its plain version
on the CPU (the reference calls its jnp oracle; the kernel is bit-identical
to it, so no result differs). Where the forward records no gradient, the
PLAN sigmoid and the 8-bit signal after it are one stage,
``sig_ops.sigmoid_pw_signal`` (one launch on the card), bit for bit the
reference's two calls; a forward that records a gradient makes the two
calls, which carry the PLAN and straight-through gradients.

Any weight form runs: float masters (float or STE fake-quant policy) and
the ``export_container`` serve form, whose hidden layers go through the
``qmatvec`` kernel and whose 8-bit head goes through ``qmatmul``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.core import qat, quant_dense
from repro_torch.core.precision import QuantPolicy
from repro_torch.core.treeutil import flatten_with_path
from repro_torch.kernels.sigmoid_pw import ops as sig_ops

__all__ = ["init", "forward", "num_params"]


def init(gen: torch.Generator, input_dim: int, hidden: Sequence[int],
         num_classes: int, dtype=torch.float32, device=None) -> Dict[str, Any]:
    """Layers ``fc0..fcN-1`` and ``head`` from ``gen`` (on ``device``)."""
    dims = [input_dim, *hidden, num_classes]
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        # Glorot's sigmoid gain: sigmoid(x) ~ 0.5 + x/4 attenuates signals 4x
        # per layer; x4 init keeps unit gain through the 3-4 hidden layers
        layers.append(quant_dense.init(gen, a, b, bias=True, dtype=dtype,
                                       device=device, scale=4.0 / (a ** 0.5)))
    # the classifier is named 'head' so path-based role inference applies
    # the paper's sensitive-output rule (8-bit)
    names = [f"fc{i}" for i in range(len(layers) - 1)] + ["head"]
    return dict(zip(names, layers))


def _sigmoid(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "exact":
        return torch.sigmoid(x)
    return sig_ops.sigmoid_pw(x)


def forward(params: Dict[str, Any], x: torch.Tensor, *, policy: QuantPolicy,
            deltas: Optional[Dict] = None, sigmoid_mode: str = "exact",
            ) -> torch.Tensor:
    """x: (B, input_dim) -> logits (B, classes). Every hidden matrix is
    'hidden' (3-bit under W3A8), the classifier 'output' (8-bit)."""
    n = len(params)
    d = deltas or {}
    h = x
    names = [f"fc{i}" for i in range(n - 1)] + ["head"]
    for i, name in enumerate(names):
        role = "output" if name == "head" else "hidden"
        h = quant_dense.apply(params[name], h, policy=policy, role=role,
                              delta=(d.get(name) or {}).get("w"))
        if i < n - 1:
            if sigmoid_mode == "pw" and policy.act_bits and not (
                    torch.is_grad_enabled() and h.requires_grad):
                h = sig_ops.sigmoid_pw_signal(h, policy.act_bits)
                continue
            h = _sigmoid(h, sigmoid_mode)
            if policy.act_bits:                # paper: 8-bit signals, in [0,1]
                h = qat.fake_quant_act(h, policy.act_bits, signed=False)
    return h


def num_params(params) -> int:
    return sum(int(p.numel()) for p in flatten_with_path(params).values())
