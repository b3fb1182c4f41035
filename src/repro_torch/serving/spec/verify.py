"""Verify phase — port of the reference's ``serving/spec/verify.py``: one
target pass over [pending, drafts] through ``models.api.verify_step``.
Position ``t`` of the logits is the target's distribution over the token
after input ``t``: logits 0..K-1 judge drafts 1..K, logits K give the bonus
token when every draft is accepted."""
from __future__ import annotations

import torch

from repro_torch.models import api as model_api

__all__ = ["verify_tokens"]


def verify_tokens(params, cache, pending: torch.Tensor, drafts: torch.Tensor,
                  cfg, **kw):
    """Score K drafts with one target pass. ``pending`` (B, 1) is the
    committed, not yet fed token, ``drafts`` (B, K) the proposals. Returns
    ``(target_logits (B, K+1, V), cache, trajectory)``; the cache advances
    by K + 1 positions, rolled back to the accepted prefix afterwards."""
    inputs = torch.cat([pending, drafts.to(pending.dtype)], dim=1)
    return model_api.verify_step(params, cache, inputs, cfg, **kw)
