"""Public wrapper of the int8-level matmul.

Flattens leading batch dims and dispatches on the tensor's device: a CPU
tensor runs the plain version (``ref.qmatmul_ref``), a CUDA tensor the
hand-written kernel (``kernel.qmatmul_cuda``), which raises rather than
fall back. Serves the ``q`` weight form and the tied-embedding readout
(``quant_dense.tied_logits`` passes the transposed table view).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.qmatmul import kernel, ref

__all__ = ["qmatmul"]


def qmatmul(x: torch.Tensor, w_q: torch.Tensor, delta,
            bias: torch.Tensor | None = None,
            out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """(..., K) x (K, N) int8 levels -> (..., N); delta (N,) or scalar and
    bias (N,) apply in fp32 after the accumulation; ``out_dtype`` (default
    x's) is the one cast."""
    lead = x.shape[:-1]
    k, n = w_q.shape
    x2 = x.reshape(-1, k)
    if x.device.type == "cpu":
        out = ref.qmatmul_ref(x2, w_q, delta, bias=bias, out_dtype=out_dtype)
    elif x.is_cuda:
        if isinstance(delta, (int, float)):      # the tied readout's 1.0
            d = torch.full((n,), float(delta), dtype=torch.float32,
                           device=x.device)
        else:
            d = torch.as_tensor(delta, dtype=torch.float32, device=x.device)
            d = d.reshape(-1).expand(n).contiguous()
        b = None if bias is None else bias.to(torch.float32).contiguous()
        out = kernel.qmatmul_cuda(x2.contiguous(), w_q, d, b, out_dtype)
    else:
        raise ValueError(f"qmatmul: no path for device {x.device}")
    return out.reshape(*lead, n)
