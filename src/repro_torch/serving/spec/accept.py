"""Acceptance-rejection sampling for speculative decoding — port of the
reference's ``serving/spec/accept.py``, exact in the target distribution:

  * T = 0: draft ``x_i`` is accepted iff it equals the target's argmax
    after ``x_1 .. x_{i-1}``; the first mismatch emits the target's argmax
    instead, so the stream is token-identical to greedy decoding.
  * T > 0: draft ``x_i`` is accepted with probability
    ``min(1, p_t(x_i) / p_d(x_i))``; a rejection draws its replacement from
    the residual ``norm(max(p_t - p_d, 0))``, and when all K drafts are
    accepted a bonus token comes from the target's (K+1)-th distribution.
    Each emitted token is distributed as the target's
    ``softmax(logits / T)``. The draws come from an explicit
    ``torch.Generator``, so the streams differ from the reference's
    ``jax.random`` ones; their distribution does not.

Vectorised over the batch: a tick decides every slot on the device, with no
host sync.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["spec_accept", "emit_counts", "categorical"]

_TINY = 1e-30


def categorical(probs: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One draw per row of ``probs`` (B, V), unnormalised weights >= 0:
    ``torch.multinomial(probs, 1, generator=generator)[:, 0]`` step for
    step (exponential noise, argmax of the ratio), so the same stream, but
    without its host-side check of the weights, which syncs and so cannot
    be captured in a CUDA graph, and which raises on the NaN row of a
    poisoned slot that the caller masks out anyway."""
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q, dim=-1)


def spec_accept(draft_toks: torch.Tensor, draft_logits: torch.Tensor,
                target_logits: torch.Tensor, *, temperature: float,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Acceptance-rejection over a (B, K) draft window.

    ``draft_toks`` (B, K) int; ``draft_logits`` (B, K, V) the drafter's
    logits that produced them; ``target_logits`` (B, K+1, V) from
    ``verify_step`` (position ``i`` is the target's distribution after
    draft ``i``, position K the bonus one).

    Returns ``(accept_len (B,), out_tokens (B, K+1), next_pending (B,))``,
    int32: ``a`` in [0, K] drafts accepted; ``out_tokens[:, :a + 1]`` is the
    emitted window (the accepted drafts and one correction or bonus token,
    which is also ``next_pending``, the next tick's input)."""
    b, k = draft_toks.shape
    draft_toks = draft_toks.long()
    steps = torch.arange(k + 1, device=draft_toks.device)
    if temperature == 0.0:
        t_hat = torch.argmax(target_logits, dim=-1)                # (B, K+1)
        match = draft_toks == t_hat[:, :k]
        a = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
        extra = torch.gather(t_hat, 1, a[:, None].long())[:, 0]
    else:
        pt = torch.softmax(target_logits.float() / temperature, dim=-1)
        pd = torch.softmax(draft_logits.float() / temperature, dim=-1)
        ptx = torch.gather(pt[:, :k], 2, draft_toks[..., None])[..., 0]
        pdx = torch.gather(pd, 2, draft_toks[..., None])[..., 0]   # (B, K)
        u = torch.rand((b, k), generator=generator,
                       device=draft_toks.device)
        # accept iff u < p_t(x) / p_d(x); the multiplied form has no divide
        acc = u * torch.clamp(pdx, min=_TINY) < ptx
        a = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)
        rows = torch.arange(b, device=draft_toks.device)
        pt_a = pt[rows, a.long()]
        pd_a = pd[rows, torch.clamp(a, max=k - 1).long()]
        res = torch.clamp(pt_a - pd_a, min=0.0)
        rsum = res.sum(dim=-1, keepdim=True)
        # rsum == 0 <=> p_t == p_d, where a rejection has probability 0:
        # the p_t fallback only guards that impossible draw
        res = torch.where(rsum > 0, res / torch.clamp(rsum, min=_TINY), pt_a)
        dist = torch.where((a >= k)[:, None], pt_a, res)
        extra = categorical(dist + _TINY, generator)
    padded = torch.cat([draft_toks, extra[:, None]], dim=1)
    out = torch.where(steps[None, :] < a[:, None], padded, extra[:, None])
    return (a.to(torch.int32), out.to(torch.int32), extra.to(torch.int32))


def emit_counts(out_tokens: torch.Tensor, accept_len: torch.Tensor, *,
                active: torch.Tensor, emitted: torch.Tensor,
                budget: torch.Tensor, eos_id: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cut each slot's emitted window at its remaining budget and its first
    EOS. Returns ``(n_emit (B,), done (B,))``: inactive slots emit 0;
    active ones ``min(accept_len + 1, budget - emitted)`` tokens, cut after
    the first EOS in that window (``eos_id < 0`` never matches). ``done``
    marks slots whose request finished this tick."""
    t1 = out_tokens.shape[1]
    steps = torch.arange(t1, device=out_tokens.device)
    n = torch.minimum(accept_len + 1, budget - emitted)           # >= 1 if active
    hit = (out_tokens == eos_id) & (steps[None, :] < n[:, None])
    first = torch.where(hit, steps[None, :], t1).amin(dim=1)
    eos_hit = first < n
    n = torch.where(eos_hit, first + 1, n)
    n = torch.where(active, n, torch.zeros_like(n)).to(torch.int32)
    done = active & ((emitted + n >= budget) | eos_hit)
    return n, done
