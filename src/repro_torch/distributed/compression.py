"""Gradient compression for slow (cross-pod) links — port of the
reference's ``distributed/compression.py``: int8 quantization with error
feedback.

Gradients, like weights, tolerate aggressive quantization if the error is
fed back: 4x fewer bytes over the pod axis, and the residual is carried
to the next step so the compression bias vanishes in expectation.

``make_grad_compressor`` returns a ``grad_transform`` for
``training.loop.make_train_step``: grads are quantized int8 (per-leaf
absmax scale), dequantized, and the quantization residual is kept in the
train state under ``"ef"``. A captured step reads fixed tensors, so the
port makes ``"ef"`` (zeros, fp32, one leaf a gradient) before the first
call with :func:`init_error_feedback`, where the reference makes it
lazily; the transform writes the residual into it in place.

``compressed_psum`` is the manual collective: quantize locally,
all-reduce the int8 payloads as int32 over one mesh dim's group, average
the scales, multiply.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.treeutil import (flatten_with_path, map_with_path,
                                       unflatten)

__all__ = ["quantize_grad", "dequantize_grad", "make_grad_compressor",
           "init_error_feedback", "compressed_psum"]


def quantize_grad(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 levels, fp32 0-d scale = max(max|g|, 1e-20) / 127)."""
    scale = torch.clamp(g.abs().amax(), min=1e-20) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_grad(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_feedback(params) -> dict:
    """The zero residual tree (fp32, one leaf a parameter) a compressed
    step carries as ``state["ef"]``."""
    return map_with_path(
        lambda p, t: torch.zeros_like(t, dtype=torch.float32), params)


def make_grad_compressor():
    """``grad_transform(grads, state) -> (grads', state)`` with error
    feedback; ``state["ef"]`` (see :func:`init_error_feedback`) is
    updated in place."""

    def transform(grads, state):
        ef = state.get("ef")
        if ef is None:
            raise ValueError('the compressed step needs state["ef"]: build '
                             'it with init_error_feedback(params)')
        out = {}
        efs = flatten_with_path(ef)
        for path, g in flatten_with_path(grads).items():
            e = efs[path]
            g = g.to(torch.float32) + e
            q, s = quantize_grad(g)
            gq = dequantize_grad(q, s)
            e.copy_(g - gq)
            out[path] = gq
        return unflatten(out), state

    return transform


def compressed_psum(g: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum over ``mesh``'s dim ``axis`` of every rank's ``g``, sent as
    int8: each rank quantizes its ``g``, the int8 payloads are summed as
    int32 by an all-reduce over that dim's group and the scales averaged;
    returns the int32 total times the mean scale (fp32)."""
    import torch.distributed as dist
    group = mesh.get_group(axis)
    q, s = quantize_grad(g)
    total = q.to(torch.int32)
    dist.all_reduce(total, group=group)
    s = s.clone()
    dist.all_reduce(s, group=group)
    s = s / dist.get_world_size(group)
    return total.to(torch.float32) * s
