"""Losses and metrics (port of the reference's ``training/losses.py``)."""
from __future__ import annotations

import torch

__all__ = ["softmax_xent", "accuracy", "IGNORE"]

IGNORE = -1


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean NLL over labels != IGNORE. logits (..., V), computed in fp32."""
    logits = logits.to(torch.float32)
    valid = labels != IGNORE
    safe = torch.where(valid, labels, 0).to(torch.int64)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - ll) * valid
    return nll.sum() / torch.clamp(valid.sum(), min=1)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    valid = labels != IGNORE
    pred = torch.argmax(logits, dim=-1)
    return ((pred == labels) * valid).sum() / torch.clamp(valid.sum(), min=1)
