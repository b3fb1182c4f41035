"""Sharding rules — port of the reference's ``distributed/sharding.py``:
parameter specs by path and activation-constraint tables for the
production meshes, as DTensor placements.

Axes: ``data`` (+ ``pod`` when multi-pod) = data parallel; ``model`` =
tensor parallel (Megatron pattern), expert parallel (MoE, when
E % model == 0), and sequence sharding for decode KV caches.

A spec is a :class:`P`: one entry per tensor dim, each an axis name, a
tuple of names or None, as the reference's ``PartitionSpec`` is, so every
rule compares with the reference leaf by leaf. The rules read only the
mesh's axis names and sizes: a :class:`ShapeMesh` (names and sizes, no
devices) serves for the 16x16 and 2x16x16 production meshes, a
``DeviceMesh`` with ``mesh_dim_names`` for real runs. Only
:func:`tree_shardings` turns a spec into a DTensor layout
``(DeviceMesh, [placement per mesh dim])``: a tensor dim over
``("data", "model")`` becomes ``Shard(d)`` on both mesh dims, the first
named the major one, as in JAX; a mesh dim of size 1 replicates.

All rules are **divisibility-guarded**: a dim is only sharded if the axis
size divides it; otherwise the next candidate (or replication) applies.
That is what lets one rule set serve 10 architectures (GQA kv=2/8/32, MoE
E=8/16, vocab 92553, SSD heads 80, ...) on a 16-way model axis without
per-arch special cases.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.treeutil import map_with_path

__all__ = ["P", "ShapeMesh", "mesh_axes", "dp_axes", "axis_size",
           "param_specs", "state_specs", "batch_specs", "activation_rules",
           "cache_specs", "placements", "tree_shardings"]


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "model"))``. One entry
    per leading tensor dim (missing trailing entries are None)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class ShapeMesh:
    """Axis names and sizes only, for the rules: ``ShapeMesh(data=16,
    model=16)``."""

    def __init__(self, **axes: int):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a :class:`ShapeMesh` or a named DeviceMesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def dp_axes(mesh) -> Tuple[str, ...]:
    axes = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in axes)


def axis_size(mesh, name) -> int:
    if isinstance(name, (tuple, list)):
        return math.prod(axis_size(mesh, n) for n in name)
    return mesh_axes(mesh).get(name, 1)


def _replicated(shape) -> P:
    return P(*([None] * len(shape)))


def _guarded(shape: Sequence[int], mesh,
             candidates: Sequence[Tuple[int, Any]]) -> P:
    """First candidate (dim, axis) whose axis size divides shape[dim] wins.
    ``dim`` may be negative (counted from the end): rules are written
    against the *logical* weight, so stacked leading layer dims (L,) or
    (G, attn_every) don't change them."""
    spec = [None] * len(shape)
    for dim, axis in candidates:
        d = dim % len(shape)
        if shape[d] % axis_size(mesh, axis) == 0 and spec[d] is None:
            spec[d] = axis
            return P(*spec)
    return P(*spec)


def param_specs(cfg: ModelConfig, params_tree: Any, mesh,
                fsdp: bool = False) -> Any:
    """Spec tree mirroring ``params_tree`` (any leaves with ``.shape``:
    tensors, meta templates).

    ``fsdp=True`` additionally shards every >=2D weight over the ``data``
    axis on a free dim (ZeRO-3: each layer's weights are gathered in the
    forward and backward, gradients reduce-scattered). Mandatory for the
    >=8B trains: fp32 master + Adam moments replicated across 16 data rows
    do not fit."""
    model = axis_size(mesh, "model")
    kv_shardable = cfg.num_kv_heads and cfg.num_kv_heads % model == 0
    ep = cfg.num_experts and cfg.num_experts % model == 0

    def rule(path: str, leaf) -> P:
        s = tuple(leaf.shape)
        p = path.lower()
        if len(s) == 0:
            return P()
        # ---- embeddings / head -------------------------------------------
        if p.endswith("embed/w"):
            return _guarded(s, mesh, [(0, "model"), (1, "model")])
        if "head/w" in p:
            return _guarded(s, mesh, [(-1, "model"), (-2, "model")])
        # ---- attention ---------------------------------------------------
        if "attn/wq/w" in p or "attn/wq/b" in p:
            return _guarded(s, mesh, [(-1, "model")])
        if "attn/wk/" in p or "attn/wv/" in p:
            if kv_shardable:
                return _guarded(s, mesh, [(-1, "model")])
            return _replicated(s)               # replicate small GQA kv
        if "attn/wo/w" in p:
            return _guarded(s, mesh, [(-2, "model")])
        # ---- MoE ---------------------------------------------------------
        if "moe/router" in p:
            return _replicated(s)
        if "moe/up/w" in p or "moe/gate/w" in p:        # (.., E, d, f)
            cand = [(-3, "model"), (-1, "model")] if ep else [(-1, "model")]
            return _guarded(s, mesh, cand)
        if "moe/down/w" in p:                           # (.., E, f, d)
            cand = [(-3, "model"), (-2, "model")] if ep else [(-2, "model")]
            return _guarded(s, mesh, cand)
        # ---- dense MLP ---------------------------------------------------
        if "mlp/up/w" in p or "mlp/gate/w" in p:
            return _guarded(s, mesh, [(-1, "model")])
        if "mlp/down/w" in p:
            return _guarded(s, mesh, [(-2, "model")])
        # ---- mamba2 ------------------------------------------------------
        if "in_proj/w" in p:
            return _guarded(s, mesh, [(-1, "model")])
        if "/wz/w" in p or "/wx/w" in p:              # split projections
            return _guarded(s, mesh, [(-1, "model")])
        if "/wbc/" in p or "/wdt/" in p:              # tiny: replicate
            return _replicated(s)
        if "out_proj/w" in p:
            return _guarded(s, mesh, [(-2, "model")])
        if "conv_bc" in p:
            return _replicated(s)
        if "conv_x" in p or "conv_w" in p or "conv_b" in p:
            return _guarded(s, mesh, [(-1, "model")])
        # ---- everything else (norms, biases, ssm dynamics, deltas) -------
        return _replicated(s)

    def add_fsdp(spec: P, leaf) -> P:
        s = tuple(leaf.shape)
        if len(s) < 2 or "data" not in mesh_axes(mesh):
            return spec
        parts = list(spec) + [None] * (len(s) - len(spec))
        if "data" in parts:
            return spec
        # prefer the matrix dim not already model-sharded, innermost first
        for d in (-2, -1, -3):
            d2 = d % len(s)
            if d2 < len(s) - 2 and len(s) == 2:
                continue
            if parts[d2] is None and s[d2] % axis_size(mesh, "data") == 0:
                parts[d2] = "data"
                return P(*parts)
        return spec

    def rule_dispatch(path, leaf):
        # quantized-serve leaves: {"q" | "qp", "delta"} follow the weight rule
        if path.endswith("/q") or path.endswith("/qp"):
            spec = rule(path[: path.rfind("/")] + "/w", leaf)
        elif path.endswith("/delta"):
            return _replicated(leaf.shape)
        else:
            spec = rule(path, leaf)
        if fsdp and (path.endswith("/w") or path.endswith("/q")):
            spec = add_fsdp(spec, leaf)
        return spec

    return map_with_path(rule_dispatch, params_tree)


def state_specs(cfg: ModelConfig, state_tree: Any, mesh,
                fsdp: bool = False) -> Any:
    """Train-state specs: params + optimizer moments (same layout) +
    scalars; frozen deltas and an error-feedback ``ef`` tree replicated
    (``ef`` is the port's: its compressor makes it before capture)."""
    out = {"params": param_specs(cfg, state_tree["params"], mesh, fsdp=fsdp),
           "step": P()}
    if "opt" in state_tree:
        opt = {}
        for k, v in state_tree["opt"].items():
            if k == "count":
                opt[k] = P()
            else:   # moments mirror the param layout exactly
                opt[k] = param_specs(cfg, v, mesh, fsdp=fsdp)
        out["opt"] = opt
    for k in ("deltas", "ef"):
        if state_tree.get(k) is not None:
            out[k] = map_with_path(lambda p, l: _replicated(l.shape),
                                   state_tree[k])
    return out


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                batch_tree: Any) -> Any:
    dp = dp_axes(mesh)
    shardable = shape.global_batch % axis_size(mesh, dp) == 0

    def rule(path, leaf):
        spec = [None] * len(leaf.shape)
        if shardable and len(leaf.shape) >= 1:
            spec[0] = dp
        return P(*spec)

    return map_with_path(rule, batch_tree)


def activation_rules(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict:
    """Constraint table for ``distributed.context.sharding_rules``."""
    dp = dp_axes(mesh)
    bs = shape.global_batch % axis_size(mesh, dp) == 0
    b = dp if bs else None
    model = axis_size(mesh, "model")
    ep = cfg.num_experts and cfg.num_experts % model == 0
    vs = cfg.vocab_size % model == 0
    return {
        "act": P(b, None, None),
        "dec_act": P(b, None, None),
        "logits": P(b, None, "model" if vs else None),
        "moe_dispatch": P(b, None, "model" if ep else None, None),
        "moe_buffer": P(b, "model" if ep else None, None, None),
    }


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                cache_tree: Any) -> Any:
    """KV-cache / SSM-state specs for serving.

    Transformer cache leaves: (L, B, S, KV, D): batch over dp when it
    divides, **sequence over model** (the only way a 1.1TB 32k x 128 cache
    fits per-device memory). Hybrid kv: (n_apps, B, S, KV, D). SSM states:
    (L, B, H, P, N): heads over model.
    """
    dp = dp_axes(mesh)
    bs = shape.global_batch % axis_size(mesh, dp) == 0
    b = dp if bs else None
    model = axis_size(mesh, "model")

    def rule(path, leaf):
        s = tuple(leaf.shape)
        if path.endswith("len") or len(s) <= 1:
            return _replicated(s)
        if path.endswith("_scale"):                  # int8 kv token scales
            spec = [None] * len(s)
            spec[-2] = b                             # (L, B, S)
            if s[-1] % model == 0:
                spec[-1] = "model"
            return P(*spec)
        if path in ("k", "v") or path.endswith("/k") or path.endswith("/v"):
            spec = [None] * len(s)
            spec[1] = b                              # batch
            if not bs and s[2] % axis_size(mesh, "data") == 0:
                spec[2] = ("data", "model") if s[2] % axis_size(
                    mesh, ("data", "model")) == 0 else "data"
            elif s[2] % model == 0:
                spec[2] = "model"                    # sequence over model
            return P(*spec)
        if "/ssm" in path:                           # (L.., B, H, P, N)
            spec = [None] * len(s)
            spec[-4] = b
            if s[-3] % model == 0:
                spec[-3] = "model"
            return P(*spec)
        if "/conv" in path:                          # (L.., B, W-1, C)
            spec = [None] * len(s)
            spec[-3] = b
            if s[-1] % model == 0:
                spec[-1] = "model"
            return P(*spec)
        return _replicated(s)

    return map_with_path(rule, cache_tree)


def placements(mesh, spec: Sequence) -> list:
    """The DTensor placements of ``spec`` on ``mesh`` (a named
    DeviceMesh): per mesh dim, ``Shard(d)`` for the tensor dim ``d`` whose
    entry names it, else ``Replicate()``. A dim over several axes must
    name them in the mesh's order (the first the major one). A mesh dim
    of size 1 is ``Replicate()`` whatever the spec says: its one device
    holds the whole tensor either way, and a replicated placement leaves
    DTensor's sharding propagation nothing to refuse."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    sizes = list(mesh.shape)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes of dim {d} must follow "
                             f"the mesh's order {names}")
        for i in idx:
            if sizes[i] > 1:
                out[i] = Shard(d)
    return out


def tree_shardings(mesh, spec_tree: Any) -> Any:
    """Spec tree -> tree of ``(mesh, placements)``; a None spec stays
    None."""
    return map_with_path(
        lambda p, s: (mesh, placements(mesh, s)) if s is not None else None,
        spec_tree)
