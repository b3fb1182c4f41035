"""Self-speculative serving: the 3-bit model drafts, full precision
verifies — port of the reference's ``serving/spec``.

The paper's fixed-point network is nearly free to evaluate, so it drafts
for the float weights it was derived from: each tick the packed 3-bit
drafter proposes K tokens through the serving kernels, the target scores
all K + 1 positions in ONE multi-token ``verify_step``, and acceptance-
rejection sampling keeps the longest prefix the target agrees with. The
stream follows the target's distribution at any temperature, and at T = 0
is token-identical to greedy decoding.

  draft.py   ``draft_chain``: K + 1 drafter ``decode_step`` calls.
  verify.py  ``verify_tokens``: [pending, drafts] through the target's
             ``verify_step`` against the live cache.
  accept.py  ``spec_accept`` and ``emit_counts`` (budget and EOS cut of the
             emitted window).

``spec_decode_tick`` composes them and rolls both caches back; it is the
one tick core of ``ServingEngine`` and of ``generate(spec_k=)``, so the
commit arithmetic exists once. The caches are updated in place where the
reference donates them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.serving.spec.accept import (categorical, emit_counts,
                                             spec_accept)
from repro_torch.serving.spec.draft import draft_chain
from repro_torch.serving.spec.verify import verify_tokens

__all__ = ["draft_chain", "verify_tokens", "spec_accept", "emit_counts",
           "categorical", "spec_decode_tick"]


def spec_decode_tick(mod, dmod, params, dparams, cfg, dcfg, cache, dcache,
                     pending: torch.Tensor, active: torch.Tensor, *,
                     spec_k: int, temperature: float,
                     generator: Optional[torch.Generator] = None,
                     mkw: dict, dmkw: dict, attn_kw: Optional[dict] = None,
                     dattn_kw: Optional[dict] = None,
                     logit_bias: Optional[torch.Tensor] = None):
    """One speculative tick: draft -> verify -> accept -> rollback of BOTH
    caches, all on the device with no host sync.

    ``pending`` (B, 1) is each row's sampled, not yet fed token; rows of
    ``active`` (B,) advance, the others are frozen (their writes fully
    rewound, their pending token held). Returns ``(cache, dcache,
    accept_len (B,), out_tokens (B, spec_k+1), new_pending (B, 1),
    row_ok (B,))``; cutting the window at the budget and EOS
    (``emit_counts``) is the caller's.

    ``row_ok`` is True iff every verify logit of the row is finite; a row
    that is not is frozen like an inactive one, so nothing is sampled from
    a corrupt distribution. ``logit_bias`` (B,) is added to the verify
    logits before the check and acceptance.

    Commit arithmetic (its one copy): both caches advanced by spec_k + 1
    positions, and the committed stream grows by the pending token plus
    ``accept_len`` drafts, so advancing rows rewind to
    ``len - (spec_k+1) + 1 + accept_len`` and frozen rows all the way back
    to ``len - (spec_k+1)``."""
    dcache, dtraj, drafts, dlogits = draft_chain(
        dmod, dparams, dcache, pending, dcfg, spec_k=spec_k,
        temperature=temperature, generator=generator, mkw=dmkw,
        attn_kw=dattn_kw)
    tlogits, cache, vtraj = verify_tokens(params, cache, pending, drafts,
                                          cfg, **mkw, **(attn_kw or {}))
    if logit_bias is not None:
        tlogits = tlogits + logit_bias[:, None, None]
    row_ok = torch.isfinite(tlogits).all(dim=2).all(dim=1)
    advance = active & row_ok
    a, out, nxt = spec_accept(drafts, dlogits, tlogits,
                              temperature=temperature, generator=generator)
    t1 = spec_k + 1
    rows = torch.arange(pending.shape[0], device=pending.device)
    commit = torch.where(advance, cache["len"] - t1 + 1 + a,
                         cache["len"] - t1)
    cache = mod.rollback_cache(cache, rows, commit, vtraj)
    dcache = dmod.rollback_cache(dcache, rows, commit, dtraj)
    new_pending = torch.where(advance[:, None], nxt[:, None], pending)
    return cache, dcache, a, out, new_pending, row_ok
