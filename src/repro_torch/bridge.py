"""Bridge a JAX parameter, cache or training-state tree, given as numpy
arrays, into the port's tree under the same paths on a given device.

The port cannot reproduce ``jax.random`` init, so parity tests build their
parameters with the JAX package, hand them over as numpy
(``jax.device_get``) and bridge them here. int32 container words and int8
levels copy bit-exactly; bfloat16 leaves (numpy's ``ml_dtypes.bfloat16``,
which torch cannot read) go through a ``uint16`` view and come back as
``torch.bfloat16`` with the same bits. A JAX container export's untied
8-bit head is stored K-contiguous once, as the port's own export stores it
(``quant_dense.k_major_head``); its values and shape are unchanged.

A whole JAX ``TrainState`` (``jax.device_get`` of it) comes across as the
port's ``training.loop.TrainState``: the params, AdamW's ``m`` / ``v`` and
int32 ``count`` (or SGD's ``mu``), the int32 ``step`` and the frozen
``deltas``, whose None leaves stay None.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.quant_dense import k_major_head

__all__ = ["to_torch"]


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_torch(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    return _leaf_to_torch(tree, device)


def to_torch(tree: Any, device="cpu") -> Any:
    """Nested dict of numpy arrays (or scalars) -> the same dict of torch
    tensors on ``device``, bit for bit."""
    return k_major_head(_to_torch(tree, device))
