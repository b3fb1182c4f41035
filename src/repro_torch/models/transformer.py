"""Decoder-only transformer backbone, dense and MoE families — port of the
reference's ``models/transformer.py`` (GQA or MHA, QKV bias,
qk-norm, RoPE, tied embeddings or an untied head, SwiGLU or a
Mixture-of-Experts FFN (``models/moe.py``), sliding-window attention).

Parameters keep the reference's tree and its stacked layout: every leaf
under ``layers`` has a leading (L,) axis, and a Python loop over layers
takes the place of ``jax.lax.scan``. Every projection goes through
``quant_dense`` so the W3A8 policy applies.

Sliding window (``cfg.sliding_window > 0``): the cache holds
``cs = min(max_len, window)`` positions as a ring, position ``p`` at slot
``p % cs``. ``prefill`` of a prompt longer than the ring keeps its last
``cs`` positions, rolled so that each sits at its slot; ``decode_step``
and ``verify_step`` write at ``position % cs`` and attend over
``min(position + 1, cs)`` entries.

The reference is functional and donates the cache to its jitted calls;
here the cache tensors are updated IN PLACE (``decode_step``, the
``insert_prefill*`` and ``free_slots`` primitives write into the tensors
they are given and return the same dict), so one slot-major cache is
allocated once and never copied. Writes that the reference drops because
their row index is out of range (``.at[...].set(mode="drop")``) are masked
out here, since torch indexing would raise on them.

Speculative decoding: ``verify_step`` runs T tokens against the live
cache (through ``attention.verify_attention``) and ``rollback_cache``
rewinds rows to their committed lengths, zeroing the wiped entries, in
place.

Training: ``forward`` runs the whole sequence through every layer (each
checkpointed under ``remat``) and returns fp32 logits and the MoE aux
loss; ``deltas`` threads frozen per-layer step sizes
(``quant_dense.fit_deltas_stacked``) down to every projection. The
stacked leaves are split into per-layer views once (``unstack``), so the
backward stacks each leaf's gradient in one op.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant_dense
from repro_torch.core.graphs import index_drop_
from repro_torch.core.precision import QuantPolicy
from repro_torch.distributed import shards
from repro_torch.distributed.context import (constrain, merge_last,
                                             split_last)
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import (decode_attention, prefill_attention,
                                          resolve_attn_mode, verify_attention)
from repro_torch.models.layers import (apply_rope, dget, embed_init,
                                       embed_lookup, head_rmsnorm,
                                       logits_readout, mlp_apply, mlp_init,
                                       rmsnorm, rmsnorm_init, rope_freqs)

__all__ = ["init", "forward", "cache_len_for", "init_cache", "prefill",
           "decode_step", "verify_step", "spec_state_snapshot",
           "rollback_cache", "insert_prefill", "insert_prefill_many",
           "free_slots", "unstack", "remat_layer"]


# the families this module serves: audio and vlm are the dense decoder whose
# frontend prefix (``models/frontends.py``) only training feeds
FAMILIES = ("dense", "moe", "audio", "vlm")


def _check_supported(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise ValueError(f"the transformer serves the {FAMILIES} families; "
                         f"got {cfg.name} ({cfg.family})")


# --- init -----------------------------------------------------------------------

def _layer_init(gen, cfg: ModelConfig, dtype, device) -> Dict[str, Any]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    attn = {
        "wq": quant_dense.init(gen, d, h * hd, bias=cfg.qkv_bias, **kw),
        "wk": quant_dense.init(gen, d, kv * hd, bias=cfg.qkv_bias, **kw),
        "wv": quant_dense.init(gen, d, kv * hd, bias=cfg.qkv_bias, **kw),
        "wo": quant_dense.init(gen, h * hd, d, bias=False, **kw),
    }
    if cfg.qk_norm:
        attn["q_norm"] = rmsnorm_init(hd, device)
        attn["k_norm"] = rmsnorm_init(hd, device)
    p = {"ln1": rmsnorm_init(d, device), "ln2": rmsnorm_init(d, device),
         "attn": attn}
    if cfg.family == "moe":
        p["moe"] = moe_mod.moe_init(gen, cfg, **kw)
    else:
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, cfg.mlp_act, **kw)
    return p


def _stack_into(stacks, tree, i: int, n: int):
    """Copy layer ``i``'s ``tree`` into the (n, ...) ``stacks`` (allocated
    at the first layer); returns the stacks."""
    if isinstance(tree, dict):
        stacks = stacks if stacks is not None else {}
        for k, v in tree.items():
            stacks[k] = _stack_into(stacks.get(k), v, i, n)
        return stacks
    if stacks is None:
        stacks = tree.new_empty((n,) + tuple(tree.shape))
    stacks[i].copy_(tree)
    return stacks


def init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
         device=None) -> Dict[str, Any]:
    """Random float master weights from ``gen`` on ``device``, in the
    reference's stacked tree layout. The numbers differ from the
    reference's ``jax.random`` init; parity tests bridge JAX weights. Each
    layer is drawn in turn and copied into preallocated (L, ...) stacks, so
    the build holds the master and one layer, never two masters."""
    _check_supported(cfg)
    layers = None
    for i in range(cfg.num_layers):
        layers = _stack_into(layers, _layer_init(gen, cfg, dtype, device), i,
                             cfg.num_layers)
    if layers is None:        # no layer: the dry run's zero-depth lowering
        layers = _empty_stack(_layer_init(torch.Generator(), cfg, dtype,
                                          "meta"), device)
    params = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                  device),
              "layers": layers, "final_norm": rmsnorm_init(cfg.d_model, device)}
    if not cfg.tie_embeddings:
        params["head"] = quant_dense.init(gen, cfg.d_model, cfg.vocab_size,
                                          bias=False, dtype=dtype,
                                          device=device)
    return params


def _empty_stack(tree, device):
    """(0, ...) stacks of a layer tree's leaves (None stays None)."""
    if isinstance(tree, dict):
        return {k: _empty_stack(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    return torch.empty((0, *tree.shape), dtype=tree.dtype, device=device)


# --- per-layer views and remat ------------------------------------------------------

def unstack(tree, n: int):
    """The per-layer slices of a stacked tree (every leaf's leading axis
    of length ``n``): a list of ``n`` trees of views. Each leaf is split by
    one ``torch.unbind``, whose backward stacks the layers' gradients in
    one op (indexing layer by layer would build a full-size zero gradient
    for every layer). None (a tree or a leaf) gives None in every slice."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if tree is None:
        return [None] * n
    return list(torch.unbind(tree))


def remat_layer(fn, remat: str):
    """``fn`` itself, or (``remat`` other than 'none') ``fn`` under
    activation checkpointing: its activations are recomputed in the
    backward. ``preserve_rng_state=False``: the forward draws no random
    numbers, and reading the CUDA RNG state is not allowed inside a
    captured graph."""
    if remat == "none":
        return fn

    def run(*args):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return run


# --- blocks ---------------------------------------------------------------------

def _layer(layers, i: int):
    if isinstance(layers, dict):
        return {k: _layer(v, i) for k, v in layers.items()}
    return layers[i]


def _qkv(lp, h, cfg: ModelConfig, policy, positions, inv_freq, mm: str,
         ld=None):
    b, s, _ = h.shape
    hd = cfg.head_dim
    a = lp["attn"]

    def proj(name):
        return quant_dense.apply(a[name], h, policy=policy, role="hidden",
                                 delta=dget(ld, "attn", name, "w"), mode=mm)
    q = split_last(proj("wq"), (b, s, cfg.num_heads, hd))
    k = split_last(proj("wk"), (b, s, cfg.num_kv_heads, hd))
    v = split_last(proj("wv"), (b, s, cfg.num_kv_heads, hd))
    if cfg.qk_norm:
        q = head_rmsnorm(a["q_norm"]["scale"], q, cfg.norm_eps)
        k = head_rmsnorm(a["k_norm"]["scale"], k, cfg.norm_eps)
    return apply_rope(q, positions, inv_freq), apply_rope(k, positions, inv_freq), v


def _attn_out(lp, o, cfg, policy, b, s, mm: str, ld=None):
    o = merge_last(o, (b, s, cfg.num_heads * cfg.head_dim))
    return quant_dense.apply(lp["attn"]["wo"], o, policy=policy,
                             role="hidden", delta=dget(ld, "attn", "wo", "w"),
                             mode=mm)


def _ffn(lp, h, cfg: ModelConfig, policy, mm: str, ld=None):
    """(out, aux loss): the MoE block's load-balancing loss, None for an
    MLP (so the serve paths, which drop it, build nothing for it)."""
    if cfg.family == "moe":
        return moe_mod.moe_apply(lp["moe"], h, cfg, policy=policy,
                                 deltas=dget(ld, "moe"), matmul_mode=mm)
    return mlp_apply(lp["mlp"], h, act=cfg.mlp_act, policy=policy,
                     deltas=dget(ld, "mlp"), matmul_mode=mm), None


def _logits(params, h, cfg, policy, mm: str, deltas=None):
    return logits_readout(params, h, cfg, policy=policy,
                          embed_delta=dget(deltas, "embed", "w"),
                          head_delta=dget(deltas, "head", "w"),
                          matmul_mode=mm)


def _last_hidden(h: torch.Tensor, lengths) -> torch.Tensor:
    """(B, S, D) -> (B, 1, D): each row's last real position (``lengths``
    (B,)), or the last position."""
    if lengths is None:
        return h[:, -1:]
    idx = (lengths.long() - 1).reshape(-1, 1, 1).expand(-1, 1, h.shape[-1])
    return torch.gather(h, 1, idx)


def _layer_forward(lp, ld, h, cfg: ModelConfig, policy, positions, inv_freq,
                   attn_chunk: int, mm: str = "auto", attn_mode: str = "ref",
                   lengths=None):
    """One layer over a whole sequence: returns (h, aux loss or None for
    an MLP layer, (k, v)), k/v (B, S, KV, D) for a prefill's cache.
    ``ld``: the layer's frozen deltas or None. ``attn_mode`` / ``lengths`` pick the attention:
    'kernel' is the attn_prefill kernel with the bucketed-prefill mask,
    'ref' (the training default) the chunked / sliding-window reference,
    causal only."""
    b, s, _ = h.shape
    hn = rmsnorm(lp["ln1"], h, cfg.norm_eps)
    q, k, v = _qkv(lp, hn, cfg, policy, positions, inv_freq, mm, ld)
    o = prefill_attention(q, k, v, lengths=lengths,
                          window=cfg.sliding_window or 0, mode=attn_mode,
                          chunk=min(attn_chunk, s))
    h = constrain(h + _attn_out(lp, o, cfg, policy, b, s, mm, ld), "act")
    hn = rmsnorm(lp["ln2"], h, cfg.norm_eps)
    f, aux = _ffn(lp, hn, cfg, policy, mm, ld)
    return constrain(h + f, "act"), aux, (k, v)


def _cached_layer(lp, h, kv, i: int, write, valid, attend, cfg: ModelConfig,
                  policy, positions, inv_freq, mm: str, attn_mode: str):
    """One layer of decode or verify against cache entry ``i`` of ``kv``
    ({"k", "v"[, "k_scale", "v_scale"]}, leaves (L, B, S, ...)): the new
    K/V (int8 + scales for a quantized cache) go in through ``write(buf,
    i, new)``, then ``attend`` (``decode_attention`` or
    ``verify_attention``) reads the cache up to ``valid``."""
    b, t, _ = h.shape
    hn = rmsnorm(lp["ln1"], h, cfg.norm_eps)
    q, k, v = _qkv(lp, hn, cfg, policy, positions, inv_freq, mm)
    ks_ = vs_ = None
    if "k_scale" in kv:
        kq, ksc = _quantize_kv(k)
        vq, vsc = _quantize_kv(v)
        for name, new in (("k", kq), ("v", vq), ("k_scale", ksc),
                          ("v_scale", vsc)):
            write(kv[name], i, new)
        ks_, vs_ = kv["k_scale"][i], kv["v_scale"][i]
    else:
        write(kv["k"], i, k)
        write(kv["v"], i, v)
    o = attend(q, kv["k"][i], kv["v"][i], valid, k_scale=ks_, v_scale=vs_,
               mode=attn_mode)
    h = h + _attn_out(lp, o, cfg, policy, b, t, mm)
    hn = rmsnorm(lp["ln2"], h, cfg.norm_eps)
    return h + _ffn(lp, hn, cfg, policy, mm)[0]


def decode_writer(pos: torch.Tensor, cs: int, ring: bool):
    """``(write, valid)`` for one decode token of each row at ``pos`` (B,)
    into a cache of ``cs`` positions: ``write(buf, i, new)`` sets
    ``buf[i, row, slot]`` to ``new[row, 0]`` (the row's slot ``pos % cs``
    on a ring, else ``pos``, where a row past the cache writes nothing, the
    reference's dropped scatter), and ``valid`` (B,) is each row's entries
    to attend."""
    b = pos.shape[0]
    rows = torch.arange(b, device=pos.device)
    slot = (torch.remainder(pos, cs) if ring
            else torch.clamp(pos, max=cs - 1)).long()
    keep = pos < cs

    def write(buf, i, new):
        if shards.is_dtensor(buf):
            shards.write_on_shards(buf, i, rows, slot, new[:, 0],
                                   None if ring else keep)
            return
        new = new[:, 0].to(buf.dtype)
        if not ring:
            k_ = keep.reshape((b,) + (1,) * (new.dim() - 1))
            new = torch.where(k_, new, buf[i, rows, slot])
        buf[i, rows, slot] = new

    return write, torch.clamp(pos + 1, max=cs)


def verify_writer(pos0: torch.Tensor, t: int, cs: int, ring: bool):
    """``(write, valid, positions)`` for T tokens of each row from ``pos0``
    (B,): ``write(buf, i, new)`` sets the entries of positions ``pos0 ..
    pos0 + T - 1`` (each at ``position % cs`` on a ring; off a ring a
    position past the cache writes nothing), ``valid`` (B, T) is each
    query's entries to attend and ``positions`` (B, T) the positions."""
    b = pos0.shape[0]
    positions = pos0[:, None] + torch.arange(t, dtype=torch.int32,
                                             device=pos0.device)[None, :]
    rows = torch.arange(b, device=pos0.device)[:, None]
    slot = (torch.remainder(positions, cs) if ring
            else torch.clamp(positions, max=cs - 1)).long()
    # Off a ring, positions past the cache are clamped onto slot cs - 1 and
    # take the value that slot ends with (the in-range write of position
    # cs - 1, or its old entry), so the duplicate indices all write the
    # same value: the reference's dropped scatter.
    src = torch.clamp(slot - pos0[:, None], min=0)                 # (B, T)
    keep = pos0[:, None] + src < cs

    def write(buf, i, new):
        if shards.is_dtensor(buf):
            shards.write_on_shards(buf, i, rows, slot, new,
                                   None if ring else keep,
                                   src=None if ring else src)
            return
        if ring:
            buf[i, rows, slot] = new.to(buf.dtype)
            return
        k_ = keep.reshape((b, t) + (1,) * (new.dim() - 2))
        buf[i, rows, slot] = torch.where(k_, new[rows, src].to(buf.dtype),
                                         buf[i, rows, slot])

    return write, torch.clamp(positions + 1, max=cs), positions


# --- full forward (train) ----------------------------------------------------------

def _embed_input(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                 policy, deltas, dtype):
    """Token embeddings, after the frontend prefix (``frontend_embeds``
    (B, F, d)) for the audio / vlm stubs."""
    h = embed_lookup(params["embed"], batch["tokens"], policy=policy,
                     delta=dget(deltas, "embed", "w"), dtype=dtype)
    if cfg.frontend is not None and "frontend_embeds" in batch:
        h = torch.cat([batch["frontend_embeds"].to(dtype), h], dim=1)
    return h


def forward(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, *, policy: QuantPolicy,
            deltas: Optional[Dict] = None, dtype=torch.bfloat16,
            remat: str = "layer", attn_chunk: int = 1024,
            matmul_mode: str = "auto"):
    """Training / eval forward over ``batch["tokens"]`` (B, S) (and the
    frontend prefix): (logits (B, S', V) fp32, aux loss fp32 0-d, the MoE
    layers' load-balancing losses summed). Attention is the chunked
    reference, causal, and the projections are ``x @ w`` of the float
    master (its fake-quant view under a quantizing policy, with ``deltas``
    frozen or refitted), as the reference leaves them to XLA. ``remat``
    other than 'none' checkpoints each layer."""
    _check_supported(cfg)
    h = constrain(_embed_input(params, batch, cfg, policy, deltas, dtype),
                  "act")
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    inv_freq = rope_freqs(cfg.head_dim, cfg.rope_theta, h.device)

    def body(lp, ld, hh):
        hh, a, _ = _layer_forward(lp, ld, hh, cfg, policy, positions,
                                  inv_freq, attn_chunk, matmul_mode)
        return hh, a

    body = remat_layer(body, remat)
    n = cfg.num_layers
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp, ld in zip(unstack(params["layers"], n),
                      unstack(dget(deltas, "layers"), n)):
        h, a = body(lp, ld, h)
        if a is not None:
            aux = aux + a
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return _logits(params, h, cfg, policy, matmul_mode, deltas), aux


# --- serving: cache, prefill, decode ---------------------------------------------

def cache_len_for(cfg: ModelConfig, max_len: int) -> int:
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, quantized: bool = False, device=None):
    """KV cache (L, B, S, KV, D). ``quantized``: int8 entries plus
    per-(layer, batch, position) fp32 scales."""
    s = cache_len_for(cfg, max_len)
    shape = (cfg.num_layers, batch, s, cfg.num_kv_heads, cfg.head_dim)
    zeros = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)
    if quantized:
        return {"k": zeros(shape, torch.int8), "v": zeros(shape, torch.int8),
                "k_scale": zeros(shape[:3], torch.float32),
                "v_scale": zeros(shape[:3], torch.float32),
                "len": zeros((), torch.int32)}
    return {"k": zeros(shape, dtype), "v": zeros(shape, dtype),
            "len": zeros((), torch.int32)}


def _quantize_kv(x: torch.Tensor):
    """(..., S, KV, D) -> (int8 values, (..., S) scales). Per-token absmax."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=(-2, -1))
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None, None]), -127, 127)
    return q.to(torch.int8), scale


def prefill(params, batch, cfg: ModelConfig, *, policy: QuantPolicy,
            dtype=torch.bfloat16, attn_chunk: int = 1024,
            max_len: Optional[int] = None, quantize_cache: bool = False,
            lengths: Optional[torch.Tensor] = None,
            matmul_mode: str = "auto", attn_mode: str = "auto"):
    """Run the prompt, build the KV cache. Returns (last_logits (B, 1, V)
    fp32, cache).

    ``lengths`` (B,) enables right-padded multi-request prefill: row ``i``
    holds a prompt of true length ``lengths[i]`` left-aligned in the padded
    (B, S) tokens; logits are gathered at each row's last real token and
    ``cache["len"]`` is the per-row length. A padded prefill must fit the
    cache; an unpadded prompt longer than a sliding-window ring keeps its
    last ``cs`` positions, each at its ring slot."""
    _check_supported(cfg)
    tokens = batch["tokens"]
    attn_mode = resolve_attn_mode(attn_mode, tokens.device)
    h = embed_lookup(params["embed"], tokens, policy=policy, dtype=dtype)
    b, s, _ = h.shape
    max_len = max_len or s
    cs = cache_len_for(cfg, max_len)
    if lengths is not None and s > cs:
        raise ValueError(f"padded prefill length {s} exceeds cache length "
                         f"{cs}; per-row ring alignment is undefined")
    positions = torch.arange(s, device=h.device)[None, :]
    inv_freq = rope_freqs(cfg.head_dim, cfg.rope_theta, h.device)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        h, _, (k, v) = _layer_forward(_layer(params["layers"], i), None, h,
                                      cfg, policy, positions, inv_freq,
                                      attn_chunk, matmul_mode, attn_mode,
                                      lengths)
        ks.append(k[:, -cs:])
        vs.append(v[:, -cs:])
    if ks:
        ks, vs = torch.stack(ks), torch.stack(vs)          # (L, B, S, KV, D)
    else:                 # no layer: the dry run's zero-depth (L0) lowering
        ks = vs = h.new_zeros((0, h.shape[0], min(s, cs), cfg.num_kv_heads,
                               cfg.head_dim))
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=h.device).to(torch.int32)
    h = rmsnorm(params["final_norm"], _last_hidden(h, lengths), cfg.norm_eps)
    logits = _logits(params, h, cfg, policy, matmul_mode)
    if cs > ks.shape[2]:
        padw = cs - ks.shape[2]
        ks = torch.nn.functional.pad(ks, (0, 0, 0, 0, 0, padw))
        vs = torch.nn.functional.pad(vs, (0, 0, 0, 0, 0, padw))
    elif cfg.sliding_window and s >= cs and s % cs:
        # the slice put position s - cs + i at slot i; roll by s % cs so it
        # sits at its ring slot (s + i) % cs
        ks = torch.roll(ks, s % cs, dims=2)
        vs = torch.roll(vs, s % cs, dims=2)
    clen = (torch.full((), s, dtype=torch.int32, device=h.device)
            if lengths is None else lengths)
    if quantize_cache:
        qk, sk = _quantize_kv(ks)
        qv, sv = _quantize_kv(vs)
        cache = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv, "len": clen}
    else:
        cache = {"k": ks, "v": vs, "len": clen}
    return logits, cache


def decode_step(params, cache, tokens: torch.Tensor, cfg: ModelConfig, *,
                policy: QuantPolicy, dtype=torch.bfloat16,
                matmul_mode: str = "auto", attn_mode: str = "auto"):
    """One token for the whole batch. tokens: (B, 1) int. Writes the new
    K/V into ``cache`` in place and returns (logits (B, 1, V) fp32, cache
    with ``len + 1``). ``cache["len"]`` is a scalar or a (B,) vector of
    per-row lengths (slot-major continuous batching). Rows whose position
    is past the cache write nothing (the reference's dropped scatter); a
    sliding-window ring writes every row at ``pos % cs``."""
    _check_supported(cfg)
    b = tokens.shape[0]
    dev = tokens.device
    attn_mode = resolve_attn_mode(attn_mode, dev)
    pos = cache["len"].to(torch.int32).reshape(-1).expand(b)       # (B,)
    h = constrain(embed_lookup(params["embed"], tokens, policy=policy,
                               dtype=dtype), "dec_act")
    inv_freq = rope_freqs(cfg.head_dim, cfg.rope_theta, dev)
    write, valid = decode_writer(pos, cache["k"].shape[2],
                                 bool(cfg.sliding_window))
    for i in range(cfg.num_layers):
        h = _cached_layer(_layer(params["layers"], i), h, cache, i, write,
                          valid, decode_attention, cfg, policy, pos[:, None],
                          inv_freq, matmul_mode, attn_mode)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = _logits(params, h, cfg, policy, matmul_mode)
    new_cache = dict(cache)
    new_cache["len"] = cache["len"] + 1
    return logits, new_cache


def verify_step(params, cache, tokens: torch.Tensor, cfg: ModelConfig, *,
                policy: QuantPolicy, dtype=torch.bfloat16,
                matmul_mode: str = "auto", attn_mode: str = "auto"):
    """Multi-token decode against the live cache — the speculative verify
    entry point. tokens: (B, T) int, the committed last token and T - 1
    drafts. Position ``t``'s logits are the distribution over the token
    that follows ``tokens[:, t]``, as ``decode_step`` would give after
    consuming ``tokens[:, :t + 1]`` one by one. K/V of all T positions are
    written into ``cache`` in place at ``len .. len + T - 1`` (a position
    past the cache writes nothing; a sliding-window ring writes each at
    ``position % cs``); ``rollback_cache`` undoes the rejected
    ones. Returns (logits (B, T, V) fp32, cache with ``len + T``, None):
    the trailing None is the rollback trajectory, which only stateful
    families have."""
    _check_supported(cfg)
    b, t = tokens.shape
    dev = tokens.device
    attn_mode = resolve_attn_mode(attn_mode, dev)
    pos0 = cache["len"].to(torch.int32).reshape(-1).expand(b)      # (B,)
    h = constrain(embed_lookup(params["embed"], tokens, policy=policy,
                               dtype=dtype), "dec_act")
    inv_freq = rope_freqs(cfg.head_dim, cfg.rope_theta, dev)
    write, valid, positions = verify_writer(pos0, t, cache["k"].shape[2],
                                            bool(cfg.sliding_window))
    for i in range(cfg.num_layers):
        h = _cached_layer(_layer(params["layers"], i), h, cache, i, write,
                          valid, verify_attention, cfg, policy, positions,
                          inv_freq, matmul_mode, attn_mode)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = _logits(params, h, cfg, policy, matmul_mode)
    new_cache = dict(cache)
    new_cache["len"] = cache["len"] + t
    return logits, new_cache, None


def _wipe_mask(tgt: torch.Tensor, cur: torch.Tensor, cs: int) -> torch.Tensor:
    """(B, S) bool: the cache slots holding positions [tgt, cur) of each
    row — what a rollback erases. Position ``p`` lives at slot ``p % cs``,
    so the band is the cyclic interval from ``tgt % cs`` of width
    ``cur - tgt``."""
    sidx = torch.arange(cs, device=tgt.device)
    return (torch.remainder(sidx[None, :] - tgt[:, None], cs)
            < (cur - tgt)[:, None])


def spec_state_snapshot(cache):
    """The subtree a rollback restores from per-step snapshots: none, the
    dense cache is pure KV and a length rewind suffices."""
    return None


def rollback_cache(cache, slots, new_lens, trajectory=None):
    """Rewind rows ``slots`` (N,) of a slot-major cache to lengths
    ``new_lens`` (N,), in place — the speculative rejection primitive.

    Per selected row, ``len`` drops to ``new_lens`` clamped to
    [0, current] (a zero-distance rewind is the identity), and the K/V
    entries and int8 per-token scales at the wiped positions are zeroed, so
    the cache equals one that never saw the rejected tokens. Entries of
    ``slots`` >= batch are dropped. ``len`` becomes a (B,) vector.
    ``trajectory`` must be None (the dense family has no state)."""
    if trajectory is not None:
        raise ValueError("the dense cache has no state trajectory")
    b, cs = cache["k"].shape[1], cache["k"].shape[2]
    dev = cache["k"].device
    cur = cache["len"].to(torch.int32).reshape(-1).expand(b)
    idx = torch.as_tensor(slots, device=dev).long().reshape(-1)
    new = torch.as_tensor(new_lens, device=dev).to(torch.int32).reshape(-1)
    # out-of-range rows land on a spare last entry, which is cut off
    ext = torch.cat([cur, cur.new_zeros(1)])
    ext[torch.clamp(idx, max=b)] = new.expand(idx.shape[0])
    tgt = torch.minimum(torch.clamp(ext[:b], min=0), cur)
    wipe = _wipe_mask(tgt, cur, cs)                                # (B, S)
    for name in ("k", "v"):
        cache[name].masked_fill_(wipe[None, :, :, None, None], 0)
    if "k_scale" in cache:
        for name in ("k_scale", "v_scale"):
            cache[name].masked_fill_(wipe[None], 0)
    cache["len"] = tgt
    return cache


def _kv_names(cache):
    return ("k", "v") + (("k_scale", "v_scale") if "k_scale" in cache else ())


def _slot_index(idx, device) -> torch.Tensor:
    return torch.as_tensor(idx, device=device).long().reshape(-1)


def free_slots(cache, slots):
    """Zero rows ``slots`` (N,) of a slot-major cache in place and reset
    their ``len`` to 0. Entries ``>= batch`` are dropped on the device
    (``graphs.index_drop_``), so a fixed-length index never syncs."""
    idx = _slot_index(slots, cache["k"].device)
    for name in _kv_names(cache):                # leaves (L, slots, ...)
        index_drop_(cache[name], idx, 0, dim=1)
    index_drop_(cache["len"], idx, 0)
    return cache


def insert_prefill(cache, slot: int, src):
    """Copy a single-request prefill cache (batch 1, same cache length) into
    row ``slot`` of a slot-major cache whose ``len`` is per-slot, in
    place."""
    for name in _kv_names(cache):
        cache[name][:, slot] = src[name][:, 0].to(cache[name].dtype)
    cache["len"][slot] = torch.as_tensor(src["len"]).reshape(()).to(
        cache["len"].dtype)
    return cache


def insert_prefill_many(cache, slot_map, src):
    """Scatter an N-row batched prefill cache into rows ``slot_map`` (N,) of
    a slot-major cache (per-slot ``len``), in place. Entries with
    ``slot_map[i] >= slots`` are dropped on the device — the engine points
    its padding rows there, in a (slots,) map of one shape whatever the
    number of real rows, so the insert can be captured once per bucket."""
    n = src["k"].shape[1]
    idx = _slot_index(slot_map, cache["k"].device)
    for name in _kv_names(cache):                # leaves (L, slots, ...)
        index_drop_(cache[name], idx, src[name], dim=1)
    lens = torch.as_tensor(src["len"], device=cache["len"].device)
    index_drop_(cache["len"], idx, lens.reshape(-1).expand(n))
    return cache
