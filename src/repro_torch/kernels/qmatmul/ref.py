"""Plain PyTorch version of the int8-level matmul (the reference's
``qmatmul/ref.py``): the CPU path of ``ops.qmatmul`` and the oracle the
CUDA kernel is held against. ``calls`` counts its uses."""
from __future__ import annotations

import torch

__all__ = ["qmatmul_ref", "calls"]

calls = 0


def qmatmul_ref(x: torch.Tensor, w_q: torch.Tensor, delta,
                bias: torch.Tensor | None = None,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x (M, K) @ w_q (K, N) int8 levels * delta (N,) or scalar [+ bias].
    fp32 accumulate; delta and bias applied in fp32; one cast at the end."""
    global calls
    calls += 1
    out_dtype = out_dtype or x.dtype
    acc = torch.matmul(x.to(torch.float32), w_q.to(torch.float32))
    # a Python scalar multiplies as one: copied to the card as a tensor it
    # would synchronise the stream, which no captured graph may do
    acc = acc * (delta if isinstance(delta, (int, float)) else
                 torch.as_tensor(delta, dtype=torch.float32, device=x.device))
    if bias is not None:
        acc = acc + bias.to(torch.float32)
    return acc.to(out_dtype)
