"""Public wrapper of the packed-container matmul.

Flattens leading batch dims and dispatches on the tensor's device: a CPU
tensor runs the plain version (``ref.qmatvec_ref``), a CUDA tensor the
hand-written kernel (``kernel.qmatvec_cuda``), which raises rather than
fall back. Used by ``quant_dense.serve_apply`` for the ``qp`` weight form:
batched decode ``(slots, K)`` and bucketed prefill ``(slots * bucket, K)``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.qmatvec import kernel, ref

__all__ = ["qmatvec"]


def qmatvec(x: torch.Tensor, w_packed: torch.Tensor, delta, *, k: int,
            bias: torch.Tensor | None = None,
            out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """(..., K) against container-packed (KP, N) weights -> (..., N).
    ``delta`` (N,) or scalar and ``bias`` (N,) apply in fp32 after the
    accumulation; ``out_dtype`` (default x's) is the one cast."""
    lead = x.shape[:-1]
    n = w_packed.shape[-1]
    x2 = x.reshape(-1, k)
    if x.device.type == "cpu":
        out = ref.qmatvec_ref(x2, w_packed, delta, k, bias=bias,
                              out_dtype=out_dtype)
    elif x.is_cuda:
        d = torch.as_tensor(delta, dtype=torch.float32, device=x.device)
        d = d.reshape(-1).expand(n).contiguous()
        b = None if bias is None else bias.to(torch.float32).contiguous()
        out = kernel.qmatvec_cuda(x2.contiguous(), w_packed, d, b, out_dtype)
    else:
        raise ValueError(f"qmatvec: no path for device {x.device}")
    return out.reshape(*lead, n)
