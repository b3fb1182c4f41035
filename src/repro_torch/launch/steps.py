"""Step builders for sharded launches — port of the reference's
``launch/steps.py``: given (arch, shape, mesh), the step function with its
inputs' and outputs' DTensor layouts plus shape-only input templates
(``input_specs``: tensors on the ``meta`` device, the counterpart of
``jax.ShapeDtypeStruct``; no full-size tree is ever allocated).

Cell kinds:
  train    QAT train_step (W3A8 fake-quant, frozen per-layer deltas in the
           state, AdamW, microbatched, remat, FSDP for >= 6e9 parameters)
  prefill  serve forward with int8-level weights (``q`` form, 1 B/wt)
  decode   one-token serve step with container-packed weights (``qp``
           form, the paper's 0.4 B/wt on-chip image)

``quant='float'`` switches any cell to the bf16 baseline.

A cell's ``fn`` runs under ``sharding_rules`` (the activation constraints)
and DTensor's implicit replication (a plain tensor an op meets, such as
RoPE's frequencies, is every rank's same value). Its inputs are placed by
``in_shardings`` (:func:`place`); the prefill's outputs are redistributed
to ``out_shardings`` inside ``fn``, the counterpart of the reference's
``out_shardings``; the decode cell writes its cache in place (the
counterpart of ``donate=(1,)``); the train cell's step owns the state it
is first called with and updates it in place (``training.loop``), and on
a CUDA device it is captured as a CUDA graph as the one-device step is.
``cost_exact`` sets the reference's flag (``context.cost_exact_mode``),
which changes nothing in the port's computation.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import optim as optim_lib
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core import quant_dense
from repro_torch.core.precision import FLOAT, W3A8, QuantPolicy
from repro_torch.core.treeutil import map_with_path, tree_get
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import cost_exact_mode, sharding_rules
from repro_torch.models.api import get_model, init_cache
from repro_torch.models.frontends import frontend_embed_shape, text_len
from repro_torch.training.loop import make_train_step

__all__ = ["build_cell", "input_specs", "CellSpec", "FSDP_THRESHOLD",
           "place", "mesh_step", "MeshStep"]

FSDP_THRESHOLD = 6e9        # params; above this fp32 master+Adam needs ZeRO-3
PARAM_DTYPE = torch.float32  # master weights
COMPUTE_DTYPE = torch.bfloat16
META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Meta stand-ins for every model input of this cell."""
    b = shape.global_batch
    if shape.kind == "decode":
        return {"tokens": _sds((b, 1), torch.int32)}
    st = text_len(cfg, shape.seq_len)
    out = {"tokens": _sds((b, st), torch.int32)}
    if shape.kind == "train":
        out["labels"] = _sds((b, st), torch.int32)
    if cfg.frontend is not None:
        out["frontend_embeds"] = _sds(frontend_embed_shape(cfg, b),
                                      COMPUTE_DTYPE)
    return out


@dataclasses.dataclass
class CellSpec:
    """Everything one (arch x shape x mesh) cell needs."""
    fn: Any                  # the step (already wrapped)
    args: Tuple[Any, ...]    # meta templates of its inputs
    in_shardings: Any        # trees of (mesh, placements)
    out_shardings: Any
    donate: Tuple[int, ...] = ()


def place(tree: Any, shardings: Any) -> Any:
    """Each leaf of ``tree`` distributed to the ``(mesh, placements)`` at
    its path in ``shardings`` (every rank passes the same values); a leaf
    with no sharding stays as it is."""
    from torch.distributed.tensor import distribute_tensor

    def put(path, leaf):
        try:
            sh = tree_get(shardings, path) if path else shardings
        except KeyError:
            sh = None
        if sh is None:
            return leaf
        # every rank holds the value: each keeps its own chunk, with no
        # communication and, on a mesh of one device, no copy
        return distribute_tensor(leaf, sh[0], sh[1], src_data_rank=None)

    return map_with_path(put, tree)


def _policy(quant: str) -> QuantPolicy:
    return FLOAT if quant == "float" else W3A8


# --- templates (meta only: never allocates) -----------------------------------

def _params_template(cfg: ModelConfig, quant: str, kind: str):
    p = get_model(cfg).init(torch.Generator(), cfg, dtype=PARAM_DTYPE,
                            device=META)
    if kind == "train" or quant == "float":
        return p
    pol = _policy(quant)
    if kind == "prefill" or quant == "w3levels":
        return quant_dense.export_levels(p, pol)
    return quant_dense.export_container(p, pol)


def _state_template(cfg: ModelConfig, tcfg: TrainConfig, quant: str):
    p = _params_template(cfg, quant, "train")
    opt = optim_lib.make(tcfg.optimizer, momentum=tcfg.momentum,
                         weight_decay=tcfg.weight_decay)
    st = {"params": p, "opt": opt.init(p),
          "step": torch.zeros((), dtype=torch.int32, device=META)}
    if quant != "float":
        st["deltas"] = quant_dense.fit_deltas_stacked(p, _policy(quant))
    return st


def _cache_template(cfg: ModelConfig, shape: ShapeConfig,
                    kv8: bool = False):
    if kv8 and cfg.family == "ssm":
        # no KV cache to quantize: say so instead of silently building the
        # float state cache under a kv8-labelled cell
        warnings.warn(f"kv8 requested for family 'ssm' ({cfg.name}): it has "
                      "no KV cache; building the float state cache",
                      stacklevel=2)
        kv8 = False
    return init_cache(cfg, shape.global_batch, shape.seq_len, COMPUTE_DTYPE,
                      kv_bits=8 if kv8 else None, device=META)


# --- cell builders --------------------------------------------------------------

def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               quant: str = "w3", tcfg: Optional[TrainConfig] = None,
               attn_chunk: int = 1024, num_layers_override: Optional[int] = None,
               cost_exact: bool = False, fsdp: Optional[bool] = None,
               ssd_chunk: int = 0, kv8: bool = False,
               grad_transform: Optional[Callable] = None,
               capture: Optional[bool] = None, matmul_mode: str = "auto",
               attn_mode: str = "auto") -> CellSpec:
    """The cell of ``cfg`` x ``shape`` on ``mesh`` (a named DeviceMesh;
    the rules alone also take a ``sharding.ShapeMesh``). The port's own
    keywords: ``grad_transform`` (the train step's, e.g. the gradient
    compressor), ``capture`` (the train step's CUDA graph: None captures
    on a CUDA device, False runs eagerly), and the serve cells'
    ``matmul_mode`` / ``attn_mode`` ('kernel' runs the kernels' wrappers
    on the shards, which on the CPU run their plain versions)."""
    if num_layers_override is not None:
        kw = {"num_layers": num_layers_override}
        if cfg.attn_every:
            kw["attn_every"] = min(cfg.attn_every, max(num_layers_override, 1)) \
                if num_layers_override else cfg.attn_every
        cfg = dataclasses.replace(cfg, **kw)
    if shape.kind == "train":
        cell = _build_train(cfg, shape, mesh, quant, tcfg, attn_chunk, fsdp,
                            ssd_chunk, grad_transform, capture)
    elif shape.kind == "prefill":
        cell = _build_prefill(cfg, shape, mesh, quant, attn_chunk,
                              matmul_mode, attn_mode)
    else:
        cell = _build_decode(cfg, shape, mesh, quant, kv8, matmul_mode,
                             attn_mode)
    if cost_exact:
        inner = cell.fn

        def exact_fn(*args):
            with cost_exact_mode():
                return inner(*args)

        cell = dataclasses.replace(cell, fn=exact_fn)
    return cell


def _rules_ctx(cfg, shape, mesh):
    table = shd.activation_rules(cfg, shape, mesh)
    table["__mesh__"] = mesh
    return table


@contextlib.contextmanager
def _on_mesh(rules):
    """The context a cell's step runs in: the constraint table and
    DTensor's implicit replication of plain tensors."""
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication(), sharding_rules(rules):
        yield


class MeshStep:
    """A train step on a mesh: ``step(state, batch)`` run under the
    activation rules and DTensor's implicit replication; with
    ``place_batch`` each batch is first placed by it. ``step`` and
    ``captures`` are the wrapped step's."""

    def __init__(self, step, rules, place_batch=None):
        self.step, self.rules, self.place_batch = step, rules, place_batch

    @property
    def captures(self):
        return self.step.captures

    def __call__(self, state, batch):
        if self.place_batch is not None:
            batch = self.place_batch(batch)
        with _on_mesh(self.rules):
            return self.step(state, batch)


def mesh_step(step_fn, cfg: ModelConfig, shape: ShapeConfig,
              mesh) -> MeshStep:
    """``step_fn`` on ``mesh``, each plain batch placed by
    ``batch_specs`` (the state is placed once, by the caller)."""
    shardings = {}

    def place_batch(batch):
        key = tuple(sorted(batch))
        if key not in shardings:
            shardings[key] = shd.tree_shardings(
                mesh, shd.batch_specs(cfg, shape, mesh, batch))
        return place(batch, shardings[key])

    return MeshStep(step_fn, _rules_ctx(cfg, shape, mesh), place_batch)


def _build_train(cfg, shape, mesh, quant, tcfg, attn_chunk,
                 fsdp: Optional[bool] = None, ssd_chunk: int = 0,
                 grad_transform=None, capture=None) -> CellSpec:
    tcfg = tcfg or TrainConfig(
        microbatches=_default_microbatches(cfg, shape, mesh))
    policy = _policy(quant)
    if fsdp is None:
        fsdp = cfg.param_count() >= FSDP_THRESHOLD
    state_t = _state_template(cfg, tcfg, quant)
    batch_t = input_specs(cfg, shape)
    state_specs = shd.state_specs(cfg, state_t, mesh, fsdp=fsdp)
    batch_specs = shd.batch_specs(cfg, shape, mesh, batch_t)
    rules = _rules_ctx(cfg, shape, mesh)

    mkw = {"attn_chunk": attn_chunk}
    if cfg.family in ("ssm", "hybrid") and ssd_chunk:
        mkw["chunk"] = ssd_chunk
    step_fn, _ = make_train_step(cfg, tcfg, policy, dtype=COMPUTE_DTYPE,
                                 grad_transform=grad_transform,
                                 capture=capture, model_kwargs=mkw)

    metric_specs = {k: shd.P() for k in ("loss", "aux", "acc", "gnorm", "lr")}
    return CellSpec(
        fn=MeshStep(step_fn, rules),
        args=(state_t, batch_t),
        in_shardings=(shd.tree_shardings(mesh, state_specs),
                      shd.tree_shardings(mesh, batch_specs)),
        out_shardings=(shd.tree_shardings(mesh, state_specs),
                       shd.tree_shardings(mesh, metric_specs)),
        donate=(0,),
    )


def _default_microbatches(cfg, shape, mesh) -> int:
    """Keep the per-device microbatch activation footprint ~<1GB."""
    dp = shd.axis_size(mesh, shd.dp_axes(mesh))
    per_dev_batch = max(shape.global_batch // dp, 1)
    act_bytes = per_dev_batch * shape.seq_len * cfg.d_model * 2
    micro = 1
    while act_bytes / micro > (1 << 30) and micro < per_dev_batch:
        micro *= 2
    return micro


def _redistributed(tree, shardings):
    """Each DTensor leaf of ``tree`` on the placements ``shardings`` gives
    at its path (the counterpart of ``out_shardings``)."""
    from torch.distributed.tensor import DTensor

    def put(path, leaf):
        sh = tree_get(shardings, path) if path else shardings
        if sh is None or not isinstance(leaf, DTensor):
            return leaf
        return leaf.redistribute(sh[0], sh[1])

    return map_with_path(put, tree)


def _mode_kwargs(cfg, matmul_mode: str, attn_mode: str) -> Dict[str, str]:
    """The serve cells' kernel knobs: ``ssm`` has no attention, so no
    ``attn_mode`` (as the engine's ``_serve_kwargs``)."""
    if cfg.family == "ssm":
        return {"matmul_mode": matmul_mode}
    return {"matmul_mode": matmul_mode, "attn_mode": attn_mode}


def _build_prefill(cfg, shape, mesh, quant, attn_chunk,
                   matmul_mode: str = "auto",
                   attn_mode: str = "auto") -> CellSpec:
    policy = _policy(quant)
    params_t = _params_template(cfg, quant, "prefill")
    batch_t = input_specs(cfg, shape)
    pspecs = shd.param_specs(cfg, params_t, mesh)
    bspecs = shd.batch_specs(cfg, shape, mesh, batch_t)
    # a prefill's cache has the decode cache's leaves, ``len`` 0-d
    cache_t = _cache_template(cfg, shape)
    cspecs = shd.cache_specs(cfg, shape, mesh, cache_t)
    rules = _rules_ctx(cfg, shape, mesh)
    mod = get_model(cfg)
    logits_spec = shd.activation_rules(cfg, shape, mesh)["logits"]
    out_shardings = (shd.tree_shardings(mesh, logits_spec),
                     shd.tree_shardings(mesh, cspecs))

    def serve_prefill(params, batch):
        with _on_mesh(rules):
            logits, cache = mod.prefill(params, batch, cfg, policy=policy,
                                        dtype=COMPUTE_DTYPE,
                                        attn_chunk=attn_chunk,
                                        max_len=shape.seq_len,
                                        **_mode_kwargs(cfg, matmul_mode,
                                                       attn_mode))
            return (_redistributed(logits, out_shardings[0]),
                    _redistributed(cache, out_shardings[1]))

    return CellSpec(
        fn=serve_prefill,
        args=(params_t, batch_t),
        in_shardings=(shd.tree_shardings(mesh, pspecs),
                      shd.tree_shardings(mesh, bspecs)),
        out_shardings=out_shardings,
    )


def _build_decode(cfg, shape, mesh, quant, kv8: bool = False,
                  matmul_mode: str = "auto",
                  attn_mode: str = "auto") -> CellSpec:
    policy = _policy(quant)
    params_t = _params_template(cfg, quant, "decode")
    batch_t = input_specs(cfg, shape)
    cache_t = _cache_template(cfg, shape, kv8=kv8)
    pspecs = shd.param_specs(cfg, params_t, mesh)
    bspecs = shd.batch_specs(cfg, shape, mesh, batch_t)
    cspecs = shd.cache_specs(cfg, shape, mesh, cache_t)
    rules = _rules_ctx(cfg, shape, mesh)
    mod = get_model(cfg)

    def serve_decode(params, cache, batch):
        with _on_mesh(rules):
            return mod.decode_step(params, cache, batch["tokens"], cfg,
                                   policy=policy, dtype=COMPUTE_DTYPE,
                                   **_mode_kwargs(cfg, matmul_mode,
                                                  attn_mode))

    logits_spec = shd.activation_rules(cfg, shape, mesh)["logits"]
    return CellSpec(
        fn=serve_decode,
        args=(params_t, cache_t, batch_t),
        in_shardings=(shd.tree_shardings(mesh, pspecs),
                      shd.tree_shardings(mesh, cspecs),
                      shd.tree_shardings(mesh, bspecs)),
        out_shardings=(shd.tree_shardings(mesh, logits_spec),
                       shd.tree_shardings(mesh, cspecs)),
        donate=(1,),
    )
