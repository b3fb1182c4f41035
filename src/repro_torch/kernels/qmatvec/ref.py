"""Plain PyTorch version of the packed-container matmul (the reference's
``qmatvec/ref.py``): the CPU path of ``ops.qmatvec`` and the oracle the
CUDA kernel is held against. ``calls`` counts its uses."""
from __future__ import annotations

import torch

from repro_torch.core.packing import unpack_matrix

__all__ = ["qmatvec_ref", "calls"]

calls = 0


def qmatvec_ref(x: torch.Tensor, w_packed: torch.Tensor, delta, k: int,
                bias: torch.Tensor | None = None, bits: int = 3,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x (M, K) @ unpack(w_packed (ceil(K/f), N)) * delta [+ bias] -> (M, N).
    fp32 accumulate; delta and bias applied in fp32; one cast at the end."""
    global calls
    calls += 1
    out_dtype = out_dtype or x.dtype
    w = unpack_matrix(w_packed, k, bits).to(x.dtype)
    acc = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    # a Python scalar multiplies as one: copied to the card as a tensor it
    # would synchronise the stream, which no captured graph may do
    acc = acc * (delta if isinstance(delta, (int, float)) else
                 torch.as_tensor(delta, dtype=torch.float32, device=x.device))
    if bias is not None:
        acc = acc + bias.to(torch.float32)
    return acc.to(out_dtype)
