"""Unified model interface — port of the reference's ``models/api.py``:
``get_model(cfg)`` gives the family's module (dense, moe, audio and vlm:
``transformer``; ssm: ``mamba2``; hybrid: ``hybrid``).

    init(gen, cfg, dtype, device)                        -> params
    init_export(gen, cfg, exports, dtype=, device=)      -> serve tree(s)
    forward(params, batch, cfg, *, policy, deltas, ...)  -> (logits, aux)
    prefill(params, batch, cfg, *, policy, ...)          -> (logits, cache)
    decode_step(params, cache, tokens, cfg, *, policy)   -> (logits, cache)
    verify_step(params, cache, tokens, cfg, *, policy)   -> (logits, cache, traj)
    rollback_cache(cfg, cache, slots, new_lens)          -> cache (in place)
    draft_of(cfg, params, depth_fraction=)               -> (draft_cfg, qp params)
    init_cache(cfg, batch, max_len, ...)                 -> cache
    insert_prefill / insert_prefill_many / free_slots    -> cache (in place)
    cache_to_host(cfg, cache) / cache_from_host(cfg, host, like=)

``matmul_mode="auto"|"kernel"|"dequant"`` and ``attn_mode="auto"|"kernel"|
"ref"`` select the CUDA kernels or their plain versions; 'auto' takes the
kernels for CUDA tensors (``ssm`` takes no ``attn_mode``: it has no
attention). ``init_cache(..., kv_bits=8)`` stores the KV cache as int8
plus per-token fp32 scales (``ssm`` has no KV cache and refuses). The
speculative entry points (``verify_step``, ``rollback_cache``,
``spec_state_snapshot``) raise for ``ssm``: its state cannot be rewound.
"""
from __future__ import annotations

import dataclasses
from types import ModuleType
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant_dense
from repro_torch.core.precision import W3A8
from repro_torch.core.treeutil import flatten_with_path, unflatten
from repro_torch.models import hybrid, mamba2, transformer

__all__ = ["get_model", "init_export", "init_cache", "prefill", "decode_step",
           "verify_step", "rollback_cache", "spec_state_snapshot", "draft_of",
           "insert_prefill", "insert_prefill_many", "free_slots",
           "cache_to_host", "cache_from_host"]

_FAMILY_MODULE = {
    "dense": transformer, "audio": transformer, "vlm": transformer,
    "moe": transformer,
    "ssm": mamba2,
    "hybrid": hybrid,
}


def get_model(cfg: ModelConfig) -> ModuleType:
    return _FAMILY_MODULE[cfg.family]


def _each(fn, tree):
    if isinstance(tree, dict):
        return {k: _each(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_export(gen: torch.Generator, cfg: ModelConfig, exports, *,
                dtype=torch.float32, device=None):
    """The serve form of a seeded master, built without the whole master:
    ``exports`` is one function from a float tree to a serve tree
    (``quant_dense.export_container`` or ``export_levels`` under W3A8, the
    bf16 cast ``launch/serve.py::cast_weights``, the identity), or a tuple
    of them; the result is the matching tree, or tuple of trees, each
    equal bit for bit to ``export(get_model(cfg).init(gen, cfg, dtype,
    device))``, and ``gen`` is left in the state ``init`` leaves it in.

    The transformer families (dense, moe, audio, vlm) draw their parts in
    ``init``'s order (``transformer.init_parts``) and export each part as
    it is drawn: a layer as a stack of one (its leaves keep their stacked
    axis, so an export fits it exactly as it fits its slot of the whole
    stack: the fit, the levels and the packing are by stacked index and
    output column, ``quant_dense._quantize_leaf``), copied into (L, ...)
    output stacks; then the embedding, the final norm and any untied
    head, one at a time. Every export reads each part of one draw, and
    each part is freed before the next is drawn, so the device holds the
    exports, one part in fp32 and the fit's temporaries — never the
    master. ``quant_dense.k_major_head`` is applied to each finished tree
    (the whole-tree container export applies it; on any other tree it is
    the identity).

    The ssm and hybrid families compose ``init`` and the exports: their
    masters fit a card (mamba2-2.7b's is 10.8 GB), and their stacks
    (hybrid ``groups``, ``tail``) are drawn as one. So is a config with no
    layer (the dry run's zero-depth lowering)."""
    single = callable(exports)
    fns = (exports,) if single else tuple(exports)
    mod = get_model(cfg)
    if mod is not transformer or cfg.num_layers == 0:
        master = mod.init(gen, cfg, dtype, device)
        outs = tuple(f(master) for f in fns)
    else:
        n = cfg.num_layers
        layers, rest = [None] * len(fns), [{} for _ in fns]
        for key, part in transformer.init_parts(gen, cfg, dtype, device):
            if isinstance(key, int):
                one = {"layers": _each(lambda t: t[None], part)}
                for j, f in enumerate(fns):
                    layers[j] = transformer._stack_into(
                        layers[j], _each(lambda t: t[0], f(one)["layers"]),
                        key, n)
                del one
            else:
                for j, f in enumerate(fns):
                    rest[j][key] = f({key: part})[key]
            del part
        outs = tuple(quant_dense.k_major_head(transformer.assemble(s, r))
                     for s, r in zip(layers, rest))
    return outs[0] if single else outs


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               per_slot_len: bool = False, kv_bits: Optional[int] = None,
               device=None):
    """Decode cache for ``batch`` rows. ``per_slot_len`` makes ``len`` a
    (batch,) int32 vector (the batched engine's layout); ``kv_bits=8``
    allocates int8 K/V plus per-token fp32 scales (the attention-bearing
    families; ``ssm`` has no KV cache and refuses it)."""
    if kv_bits not in (None, 8):
        raise ValueError(f"kv_bits must be None or 8, got {kv_bits!r}")
    dtype = dtype or torch.bfloat16
    mod = get_model(cfg)
    if cfg.family == "ssm":
        if kv_bits:
            raise ValueError("kv_bits=8 is meaningless for family 'ssm': "
                             "it has no KV cache to quantize")
        cache = mod.init_state(cfg, batch, max_len, dtype, device=device)
    else:
        cache = mod.init_cache(cfg, batch, max_len, dtype,
                               quantized=kv_bits == 8, device=device)
    if per_slot_len:
        cache["len"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return cache


def prefill(params, batch, cfg: ModelConfig, **kw):
    return get_model(cfg).prefill(params, batch, cfg, **kw)


def decode_step(params, cache, tokens, cfg: ModelConfig, **kw):
    return get_model(cfg).decode_step(params, cache, tokens, cfg, **kw)


def verify_step(params, cache, tokens, cfg: ModelConfig, **kw):
    """Multi-token decode against the live cache (speculative verify).
    Returns (logits (B, T, V), cache, trajectory)."""
    return get_model(cfg).verify_step(params, cache, tokens, cfg, **kw)


def rollback_cache(cfg: ModelConfig, cache, slots, new_lens, trajectory=None):
    """Rewind rows ``slots`` to ``new_lens``, in place — undo rejected
    draft suffixes (see ``transformer.rollback_cache``)."""
    return get_model(cfg).rollback_cache(cache, slots, new_lens, trajectory)


def spec_state_snapshot(cfg: ModelConfig, cache):
    """The per-step snapshot a draft chain must stack for rollback (None
    for the pure-KV families, the mamba states for hybrid)."""
    return get_model(cfg).spec_state_snapshot(cache)


def _head_layers(tree, keep: int):
    if isinstance(tree, dict):
        return {k: _head_layers(v, keep) for k, v in tree.items()}
    return tree[:keep]


def _depth_slice(cfg: ModelConfig, params, depth_fraction: float):
    """The first ``depth_fraction`` of the stacked layers (at least one):
    ``layers`` for transformer and ssm, whole mamba + attention ``groups``
    for hybrid (the tail kept)."""
    out = dict(params)
    if cfg.family == "hybrid":
        n_groups = cfg.num_layers // cfg.attn_every
        keep = max(1, int(n_groups * depth_fraction))
        out["groups"] = _head_layers(params["groups"], keep)
        return dataclasses.replace(
            cfg, num_layers=keep * cfg.attn_every
            + cfg.num_layers % cfg.attn_every), out
    keep = max(1, int(cfg.num_layers * depth_fraction))
    out["layers"] = _head_layers(params["layers"], keep)
    return dataclasses.replace(cfg, num_layers=keep), out


def draft_of(cfg: ModelConfig, params, *, depth_fraction: float = 1.0):
    """A speculative DRAFTER from the same checkpoint: ``(draft_cfg,
    draft_params)``, the params being the packed 3-bit ``qp`` serve form
    (``quant_dense.export_container`` under W3A8) of the same weights —
    the paper's fixed-point network drafting for its own full-precision
    master. ``depth_fraction < 1`` keeps only the first fraction (at least
    one) of the stacked layers — for hybrid, of the whole groups, the tail
    kept — for a cheaper drafter that agrees less often. Params already in
    a serve form are sliced but not exported again."""
    if not 0.0 < depth_fraction <= 1.0:
        raise ValueError(f"depth_fraction must be in (0, 1], "
                         f"got {depth_fraction}")
    draft_cfg, draft_params = cfg, params
    if depth_fraction < 1.0:
        draft_cfg, draft_params = _depth_slice(cfg, params, depth_fraction)
    if not quant_dense.is_serve_form(draft_params):
        draft_params = quant_dense.export_container(draft_params, W3A8)
    return draft_cfg, draft_params


def free_slots(cfg: ModelConfig, cache, slots):
    return get_model(cfg).free_slots(cache, slots)


def insert_prefill(cfg: ModelConfig, cache, slot, src):
    return get_model(cfg).insert_prefill(cache, slot, src)


def insert_prefill_many(cfg: ModelConfig, cache, slot_map, src):
    return get_model(cfg).insert_prefill_many(cache, slot_map, src)


def cache_to_host(cfg: ModelConfig, cache):
    """A device cache (or any tree of tensors) on the host, dtype- and
    structure-preserving, with ONE device-to-host copy for the whole tree:
    the leaves' bytes are gathered into one buffer on the device, copied,
    and cut back into leaves on the host. Bit-identical round trip through
    :func:`cache_from_host`: bf16 or int8 K/V, the int8 scales and the
    per-slot ``len``."""
    del cfg                        # every family is a tree of tensors
    flat = flatten_with_path(cache)
    if not flat:
        return unflatten({})
    parts = [v.detach().contiguous().reshape(-1).view(torch.uint8)
             for v in flat.values()]
    host = torch.cat(parts).cpu() if len(parts) > 1 else parts[0].cpu()
    out, at = {}, 0
    for (path, v), part in zip(flat.items(), parts):
        n = part.numel()
        out[path] = host[at:at + n].clone().view(v.dtype).reshape(v.shape)
        at += n
    return unflatten(out)


def cache_from_host(cfg: ModelConfig, host_cache, *, like=None, device=None):
    """A :func:`cache_to_host` snapshot back on ``device`` (default: the
    device of ``like``, else the card). ``like`` (the engine's live cache)
    makes it validating: the paths, shapes and dtypes must match it
    exactly, so a snapshot of another engine config fails here and not in
    decode later."""
    flat_h = flatten_with_path(host_cache)
    if like is not None:
        flat_l = flatten_with_path(like)
        if sorted(flat_h) != sorted(flat_l):
            raise ValueError(
                f"cache snapshot structure mismatch for {cfg.name}: "
                f"snapshot has {sorted(flat_h)}, engine expects "
                f"{sorted(flat_l)}")
        for p, h in flat_h.items():
            ref = flat_l[p]
            if tuple(h.shape) != tuple(ref.shape) or h.dtype != ref.dtype:
                raise ValueError(
                    f"cache snapshot leaf {p} is {tuple(h.shape)}/{h.dtype}, "
                    f"engine expects {tuple(ref.shape)}/{ref.dtype} — the "
                    f"snapshot was taken under another engine config")
        device = device or next(iter(flat_l.values())).device
    device = device or "cuda"
    return unflatten({p: torch.as_tensor(h).to(device)
                      for p, h in flat_h.items()})
