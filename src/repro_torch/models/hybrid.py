"""Zamba2-style hybrid: a Mamba2 backbone plus ONE shared attention block
applied every ``attn_every`` layers (arXiv:2411.15242) — port of the
reference's ``models/hybrid.py``.

Layout: ``num_layers = n_groups * attn_every + n_tail``. A group is
``attn_every`` mamba blocks followed by the shared transformer block (the
same weights at every application). Parameters keep the reference's tree:
``groups`` leaves stacked (G, A, ...), ``tail`` leaves (n_tail, ...), one
``shared`` block made by the transformer's ``_layer_init``.

The decode cache holds per-layer mamba states and one KV cache per
shared-block application::

    {"groups": {"ssm": (G, A, B, H, P, N), "conv": (G, A, B, W-1, C)},
     "kv": {"k", "v": (G, B, S, KV, D)[, "k_scale", "v_scale": (G, B, S)]},
     "tail": {"ssm": (n_tail, B, ...), "conv": ...},     # when n_tail > 0
     "len"}

All of it is written IN PLACE (decode, verify, rollback, insert, free), so
a captured graph reads the same tensors on every replay. The shared block
runs the transformer's own layer functions, whose K/V writes land in
``kv[g]``.

Speculative decoding: ``verify_step`` advances the mamba blocks by the
exact per-token decode recurrence and returns the (T + 1)-snapshot
trajectory of their states; ``rollback_cache`` rewinds the KV by length
and restores each row's mamba state from its snapshot. ``forward`` is the
training pass (``deltas`` threaded to the groups, the tail and the shared
block).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant_dense
from repro_torch.core.graphs import index_drop_
from repro_torch.core.precision import QuantPolicy
from repro_torch.distributed.context import constrain
from repro_torch.core.treeutil import flatten_with_path, tree_map
from repro_torch.models import mamba2, transformer
from repro_torch.models.attention import (decode_attention,
                                          resolve_attn_mode, verify_attention)
from repro_torch.models.layers import (dget, embed_init, embed_lookup,
                                       rmsnorm, rmsnorm_init, rope_freqs)

__all__ = ["init", "forward", "init_cache", "cache_len_for", "prefill",
           "decode_step", "verify_step", "spec_state_snapshot",
           "rollback_cache", "insert_prefill", "insert_prefill_many",
           "free_slots"]

_STATE = ("groups", "tail")         # the subtrees holding mamba states


def _counts(cfg: ModelConfig) -> Tuple[int, int]:
    return cfg.num_layers // cfg.attn_every, cfg.num_layers % cfg.attn_every


def init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
         device=None) -> Dict[str, Any]:
    """Random float master weights from ``gen`` on ``device`` in the
    reference's tree, each mamba block drawn into preallocated stacks."""
    n_groups, n_tail = _counts(cfg)
    ga = n_groups * cfg.attn_every
    stack = None
    for i in range(ga):
        stack = transformer._stack_into(
            stack, mamba2.block_init(gen, cfg, dtype, device), i, ga)
    groups = tree_map(lambda x: x.reshape((n_groups, cfg.attn_every)
                                      + tuple(x.shape[1:])), stack)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "groups": groups,
        "shared": transformer._layer_init(gen, cfg, dtype, device),
        "final_norm": rmsnorm_init(cfg.d_model, device),
    }
    if n_tail:
        tail = None
        for i in range(n_tail):
            tail = transformer._stack_into(
                tail, mamba2.block_init(gen, cfg, dtype, device), i, n_tail)
        params["tail"] = tail
    if not cfg.tie_embeddings:
        params["head"] = quant_dense.init(gen, cfg.d_model, cfg.vocab_size,
                                          bias=False, dtype=dtype,
                                          device=device)
    return params


def _at(tree, *idx):
    return tree_map(lambda x: x[idx], tree)


def _blocks(params, cfg: ModelConfig):
    """(group or None, a, block params) of every mamba block in order: the
    groups' (each followed by the shared block), then the tail's."""
    n_groups, n_tail = _counts(cfg)
    for g in range(n_groups):
        for a in range(cfg.attn_every):
            yield g, a, _at(params["groups"], g, a)
    for t in range(n_tail):
        yield None, t, _at(params["tail"], t)


def _state_of(cache, g, a):
    """The {"ssm", "conv"} views of block (g, a) (g None: the tail's a)."""
    return (_at(cache["groups"], g, a) if g is not None
            else _at(cache["tail"], a))


# --- full forward (train) ----------------------------------------------------------

def forward(params, batch, cfg: ModelConfig, *, policy: QuantPolicy,
            deltas: Optional[Dict] = None, dtype=torch.bfloat16,
            remat: str = "layer", attn_chunk: int = 1024,
            chunk: int = mamba2.DEFAULT_CHUNK, matmul_mode: str = "auto"):
    """Training / eval forward: (logits (B, S, V) fp32, aux 0 fp32). Each
    group runs its mamba blocks (each checkpointed unless ``remat`` is
    'none', as the reference's ``_mamba_scan``) and then the shared block,
    the same weights at every application; then the tail's blocks."""
    n_groups, n_tail = _counts(cfg)
    h = embed_lookup(params["embed"], batch["tokens"], policy=policy,
                     delta=dget(deltas, "embed", "w"), dtype=dtype)
    h = constrain(h, "act")
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    inv_freq = rope_freqs(cfg.head_dim, cfg.rope_theta, h.device)

    def block(lp, ld, hh):
        return mamba2.block_apply(lp, hh, cfg, policy=policy, deltas=ld,
                                  chunk=chunk, matmul_mode=matmul_mode)

    block = transformer.remat_layer(block, remat)

    def blocks(stack, dstack, n, hh):
        for lp, ld in zip(transformer.unstack(stack, n),
                          transformer.unstack(dstack, n)):
            hh = block(lp, ld, hh)
        return hh

    for gp, gd in zip(transformer.unstack(params["groups"], n_groups),
                      transformer.unstack(dget(deltas, "groups"), n_groups)):
        h = blocks(gp, gd, cfg.attn_every, h)
        h, _, _ = transformer._layer_forward(
            params["shared"], dget(deltas, "shared"), h, cfg, policy,
            positions, inv_freq, attn_chunk, matmul_mode)
    if n_tail:
        h = blocks(params["tail"], dget(deltas, "tail"), n_tail, h)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return (transformer._logits(params, h, cfg, policy, matmul_mode, deltas),
            torch.zeros((), dtype=torch.float32, device=h.device))


# --- serving: cache, prefill, decode ---------------------------------------------

def cache_len_for(cfg: ModelConfig, max_len: int) -> int:
    """The shared block's full-attention cache holds ``max_len`` positions."""
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, quantized: bool = False, device=None):
    """Per-layer mamba states plus one KV cache per shared-block
    application. ``quantized``: int8 K/V plus per-(group, batch, position)
    fp32 scales."""
    n_groups, n_tail = _counts(cfg)
    one = mamba2.block_state(cfg, batch, device)
    # the transformer's cache with one "layer" per application
    kv = transformer.init_cache(dataclasses.replace(cfg, num_layers=n_groups),
                                batch, max_len, dtype, quantized, device)
    del kv["len"]
    cache = {"groups": {k: v.new_zeros((n_groups, cfg.attn_every)
                                       + tuple(v.shape))
                        for k, v in one.items()},
             "kv": kv,
             "len": torch.zeros((), dtype=torch.int32, device=device)}
    if n_tail:
        cache["tail"] = {k: v.new_zeros((n_tail,) + tuple(v.shape))
                         for k, v in one.items()}
    return cache


def prefill(params, batch, cfg: ModelConfig, *, policy: QuantPolicy,
            dtype=torch.bfloat16, attn_chunk: int = 1024,
            max_len: Optional[int] = None, chunk: int = mamba2.DEFAULT_CHUNK,
            quantize_cache: bool = False,
            lengths: Optional[torch.Tensor] = None,
            matmul_mode: str = "auto", attn_mode: str = "auto"):
    """Prompt pass: (last logits (B, 1, V) fp32, cache). ``lengths`` (B,)
    enables right-padded multi-request prefill: the mamba blocks mask the
    recurrence and gather each row's true conv tail, the attention is
    causal so real positions never see the padding, and the junk K/V at
    padded positions is masked by decode (per-row ``len``) until
    overwritten. ``quantize_cache`` stores int8 K/V plus per-token
    scales."""
    tokens = batch["tokens"]
    attn_mode = resolve_attn_mode(attn_mode, tokens.device)
    bsz, s = tokens.shape
    max_len = max_len or s
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=tokens.device).to(
            torch.int32)
        if s > max_len:
            raise ValueError(f"padded prefill length {s} exceeds max_len "
                             f"{max_len}")
    h = embed_lookup(params["embed"], tokens, policy=policy, dtype=dtype)
    positions = torch.arange(s, device=h.device)[None, :]
    inv_freq = rope_freqs(cfg.head_dim, cfg.rope_theta, h.device)
    states: Dict[str, Dict[str, list]] = {}
    ks, vs = [], []
    for g, a, lp in _blocks(params, cfg):
        h, st = mamba2.block_apply(lp, h, cfg, policy=policy, chunk=chunk,
                                   return_state=True, lengths=lengths,
                                   matmul_mode=matmul_mode)
        sub = states.setdefault("groups" if g is not None else "tail", {})
        for k, v in st.items():
            sub.setdefault(k, []).append(v)
        if g is not None and a == cfg.attn_every - 1:
            h, _, (k, v) = transformer._layer_forward(
                params["shared"], None, h, cfg, policy, positions, inv_freq,
                attn_chunk, matmul_mode, attn_mode, lengths)
            ks.append(k)
            vs.append(v)
    n_groups, _ = _counts(cfg)
    cache = {"groups": {k: torch.stack(v).reshape(
        (n_groups, cfg.attn_every) + tuple(v[0].shape))
        for k, v in states["groups"].items()}}
    if "tail" in states:
        cache["tail"] = {k: torch.stack(v) for k, v in states["tail"].items()}
    pad = (0, 0, 0, 0, 0, max_len - s)
    kk = torch.nn.functional.pad(torch.stack(ks), pad)   # (G, B, S, KV, D)
    vv = torch.nn.functional.pad(torch.stack(vs), pad)
    if quantize_cache:
        qk, sk = transformer._quantize_kv(kk)
        qv, sv = transformer._quantize_kv(vv)
        cache["kv"] = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
    else:
        cache["kv"] = {"k": kk.to(dtype), "v": vv.to(dtype)}
    cache["len"] = (torch.full((), s, dtype=torch.int32, device=h.device)
                    if lengths is None else lengths)
    h = rmsnorm(params["final_norm"], transformer._last_hidden(h, lengths),
                cfg.norm_eps)
    return transformer._logits(params, h, cfg, policy, matmul_mode), cache


def _step(params, cache, tokens, cfg, policy, dtype, mm, attn_mode, mamba,
          write, valid, attend, positions):
    """The model over ``tokens`` against the live cache: ``mamba(lp, h,
    g, a)`` runs (and writes) one mamba block, the shared block runs the
    transformer's ``_cached_layer`` against ``kv[g]``. Returns the final
    normed hidden state's logits."""
    h = embed_lookup(params["embed"], tokens, policy=policy, dtype=dtype)
    inv_freq = rope_freqs(cfg.head_dim, cfg.rope_theta, tokens.device)
    for g, a, lp in _blocks(params, cfg):
        h = mamba(lp, h, g, a)
        if g is not None and a == cfg.attn_every - 1:
            h = transformer._cached_layer(
                params["shared"], h, cache["kv"], g, write, valid, attend,
                cfg, policy, positions, inv_freq, mm, attn_mode)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return transformer._logits(params, h, cfg, policy, mm)


def decode_step(params, cache, tokens: torch.Tensor, cfg: ModelConfig, *,
                policy: QuantPolicy, dtype=torch.bfloat16,
                matmul_mode: str = "auto", attn_mode: str = "auto"):
    """One token for the whole batch, every state and K/V written in place.
    ``cache["len"]`` is a scalar or (B,) per-row lengths; a row past the
    cache writes no K/V. Returns (logits (B, 1, V) fp32, cache with
    ``len + 1``)."""
    b = tokens.shape[0]
    attn_mode = resolve_attn_mode(attn_mode, tokens.device)
    pos = cache["len"].to(torch.int32).reshape(-1).expand(b)       # (B,)
    write, valid = transformer.decode_writer(pos, cache["kv"]["k"].shape[2],
                                             False)

    def mamba(lp, h, g, a):
        st = _state_of(cache, g, a)
        h, new = mamba2.block_decode(lp, h, st, cfg, policy=policy,
                                     matmul_mode=matmul_mode)
        for k, v in new.items():
            st[k].copy_(v)
        return h

    logits = _step(params, cache, tokens, cfg, policy, dtype, matmul_mode,
                   attn_mode, mamba, write, valid, decode_attention,
                   pos[:, None])
    out = dict(cache)
    out["len"] = cache["len"] + 1
    return logits, out


def _trajectory_buffers(cache, t: int):
    """Empty (T + 1, ...) snapshot stacks shaped like the mamba state
    subtrees, entry 0 already the pre-verify state."""
    traj = {}
    for name in _STATE:
        if name in cache:
            traj[name] = tree_map(
                lambda x: x.new_empty((t + 1,) + tuple(x.shape)), cache[name])
            tree_map(lambda d, x: d[0].copy_(x), traj[name], cache[name])
    return traj


def verify_step(params, cache, tokens: torch.Tensor, cfg: ModelConfig, *,
                policy: QuantPolicy, dtype=torch.bfloat16,
                matmul_mode: str = "auto", attn_mode: str = "auto"):
    """Multi-token decode against the live cache — the speculative verify
    entry point. tokens (B, T). Returns (logits (B, T, V) fp32, cache with
    ``len + T``, trajectory).

    Each mamba block runs ``block_decode`` T times, token by token (the
    reference's ``_mamba_verify``), so its states are exactly the ones
    sequential decode carries; the shared block writes T K/V entries per
    application and masks the drafts causally (``verify_attention``).
    ``trajectory`` {"groups"[, "tail"]} holds the mamba states after each
    of the T tokens, snapshot axis first (entry ``j`` = state after
    ``tokens[:, :j]``); :func:`rollback_cache` selects each row's entry."""
    b, t = tokens.shape
    attn_mode = resolve_attn_mode(attn_mode, tokens.device)
    pos0 = cache["len"].to(torch.int32).reshape(-1).expand(b)      # (B,)
    write, valid, positions = transformer.verify_writer(
        pos0, t, cache["kv"]["k"].shape[2], False)
    traj = _trajectory_buffers(cache, t)

    def mamba(lp, h, g, a):
        st = _state_of(cache, g, a)
        snaps = (_at(traj["groups"], slice(None), g, a) if g is not None
                 else _at(traj["tail"], slice(None), a))
        outs = []
        for i in range(t):
            h_t, st = mamba2.block_decode(lp, h[:, i:i + 1], st, cfg,
                                          policy=policy,
                                          matmul_mode=matmul_mode)
            outs.append(h_t)
            tree_map(lambda d, x: d[i + 1].copy_(x), snaps, st)
        tree_map(lambda d, x: d.copy_(x), _state_of(cache, g, a), st)
        return torch.cat(outs, dim=1)

    logits = _step(params, cache, tokens, cfg, policy, dtype, matmul_mode,
                   attn_mode, mamba, write, valid, verify_attention,
                   positions)
    out = dict(cache)
    out["len"] = cache["len"] + t
    return logits, out, traj


def spec_state_snapshot(cache):
    """The subtree a rollback restores from per-step snapshots: the mamba
    states {"groups"[, "tail"]}. The KV part rewinds by length."""
    return {name: cache[name] for name in _STATE if name in cache}


def _select_state(traj_leaf: torch.Tensor, j: torch.Tensor, baxis: int):
    """Per-row snapshot select: ``traj_leaf`` (T + 1, ...) with the batch
    axis at ``baxis``; ``j`` (B,) each row's snapshot. Returns the leaf
    without the snapshot axis (batch at ``baxis - 1``)."""
    moved = torch.movedim(traj_leaf, baxis, 0)                  # (B, T+1, ...)
    sel = moved[torch.arange(j.shape[0], device=j.device), j.long()]
    return torch.movedim(sel, 0, baxis - 1)


def rollback_cache(cache, slots, new_lens, trajectory=None):
    """Rewind rows ``slots`` (N,) of a slot-major hybrid cache to lengths
    ``new_lens`` (N,), in place. The K/V entries and int8 scales at the
    wiped positions are zeroed and ``len`` drops (clamped to [0, current];
    zero-distance rewinds and out-of-range ``slots`` entries are
    identities), as in the transformer family. The mamba states are
    restored from ``trajectory`` (from :func:`verify_step` or a draft
    chain's snapshot stack): row ``b`` takes snapshot ``new_len[b] -
    (current_len[b] - T)``, written into the live state tensors. With
    ``trajectory=None`` they are left as they are, which is sound only if
    they never advanced past ``new_lens``."""
    b = cache["kv"]["k"].shape[1]
    cur = cache["len"].to(torch.int32).reshape(-1).expand(b)
    kv = dict(cache["kv"], len=cache["len"])
    tgt = transformer.rollback_cache(kv, slots, new_lens)["len"]
    if trajectory is not None:
        first = next(iter(flatten_with_path(trajectory).values()))
        t_steps = first.shape[0] - 1
        j = torch.clamp(tgt - (cur - t_steps), 0, t_steps)
        for name, baxis in (("groups", 3), ("tail", 2)):
            if name in trajectory:
                tree_map(lambda d, tr: d.copy_(_select_state(tr, j, baxis)),
                         cache[name], trajectory[name])
    cache["len"] = tgt
    return cache


# batch axis of each cache subtree
_BATCH_AXIS = {"groups": 2, "kv": 1, "tail": 1}


def free_slots(cache, slots):
    """Zero rows ``slots`` (N,) of a slot-major hybrid cache in place — K/V
    (and int8 scales), mamba group and tail states, ``len`` — back to the
    fresh state. Entries ``>= batch`` are dropped on the device."""
    idx = transformer._slot_index(slots, cache["len"].device)
    for name, axis in _BATCH_AXIS.items():
        if name in cache:
            for leaf in flatten_with_path(cache[name]).values():
                index_drop_(leaf, idx, 0, dim=axis)
    index_drop_(cache["len"], idx, 0)
    return cache


def insert_prefill(cache, slot: int, src):
    """Copy a single-request prefill cache (batch 1, same max_len) into row
    ``slot`` of a slot-major cache whose ``len`` is per-slot, in place."""
    for name, axis in _BATCH_AXIS.items():
        if name in cache:
            tree_map(lambda d, s: d.narrow(axis, slot, 1).copy_(
                s.to(d.dtype)), cache[name], src[name])
    cache["len"][slot] = torch.as_tensor(src["len"]).reshape(()).to(
        cache["len"].dtype)
    return cache


def insert_prefill_many(cache, slot_map, src):
    """Scatter an N-row batched prefill cache into rows ``slot_map`` (N,) of
    a slot-major cache (per-slot ``len``), in place; entries ``slot_map[i]
    >= slots`` are dropped on the device."""
    idx = transformer._slot_index(slot_map, cache["len"].device)
    for name, axis in _BATCH_AXIS.items():
        if name in cache:
            tree_map(lambda d, s: index_drop_(d, idx, s, dim=axis),
                     cache[name], src[name])
    lens = torch.as_tensor(src["len"], device=cache["len"].device)
    index_drop_(cache["len"], idx, lens.reshape(-1).expand(idx.shape[0]))
    return cache
