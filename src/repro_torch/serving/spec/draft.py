"""Draft phase — port of the reference's ``serving/spec/draft.py``: the
drafter's proposals from spec_k + 1 eager ``decode_step`` calls (the
reference runs them under one ``lax.scan``), through the drafter's own
serving path (for ``qp`` params the qmatvec, qmatmul and attn_decode
kernels), and for a stateful drafter (hybrid) the stack of its state
snapshots that rollback selects from."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.treeutil import tree_map
from repro_torch.serving.spec.accept import categorical

__all__ = ["draft_chain"]


def draft_chain(mod, draft_params, dcache, pending: torch.Tensor, dcfg, *,
                spec_k: int, temperature: float,
                generator: Optional[torch.Generator] = None,
                mkw: dict, attn_kw: Optional[dict] = None):
    """Run ``spec_k + 1`` drafter decode steps from the committed stream.

    ``pending`` (B, 1): the last sampled, not yet fed token. Step ``j``
    consumes the previous token and samples proposal ``x_{j+1}``. The chain
    runs ONE step past the K proposals so the drafter's cache also holds
    the entry of its own last proposal ``x_K``; otherwise a tick that
    accepts everything would leave the draft cache one entry short of the
    committed stream. The last step's sample is discarded.

    Returns ``(dcache, trajectory, drafts (B, K), draft_logits (B, K, V))``.
    ``trajectory`` stacks the drafter's rollback snapshots
    (``mod.spec_state_snapshot``), the pre-draft state first, so entry
    ``j`` is the state after ``j`` steps (copies: ``decode_step`` advances
    the state in place); None for a pure-KV drafter."""
    snap0 = mod.spec_state_snapshot(dcache)
    traj = None
    if snap0 is not None:
        traj = tree_map(lambda x: x.new_empty((spec_k + 2,) + x.shape),
                        snap0)
        tree_map(lambda d, x: d[0].copy_(x), traj, snap0)
    cur, logits, toks = pending, [], []
    for j in range(spec_k + 1):
        lg, dcache = mod.decode_step(draft_params, dcache, cur, dcfg, **mkw,
                                     **(attn_kw or {}))
        if traj is not None:
            tree_map(lambda d, x: d[j + 1].copy_(x), traj,
                     mod.spec_state_snapshot(dcache))
        lg = lg[:, 0]
        if temperature == 0.0:
            nxt = torch.argmax(lg, dim=-1)
        else:
            probs = torch.softmax(lg.float() / temperature, dim=-1)
            nxt = categorical(probs, generator)
        cur = nxt.to(torch.int32)[:, None]
        logits.append(lg)
        toks.append(cur[:, 0])
    drafts = torch.stack(toks[:spec_k], dim=1)                   # (B, K)
    draft_logits = torch.stack(logits[:spec_k], dim=1)           # (B, K, V)
    return dcache, traj, drafts, draft_logits
