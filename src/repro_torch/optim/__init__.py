"""Optimizers on dicts of tensors: SGD with momentum, the paper's trainer
(§2.1: lr 0.1/0.05, momentum 0.9), and AdamW for the LM zoo; LR schedules
and global-norm clipping.

Port of the reference's ``optim``. ``opt = make(name, **hp); state =
opt.init(params); opt.update_(grads, state, params, lr)`` writes the new
parameters and optimizer state into the tensors it is given, leaf by leaf:
a step captured as a CUDA graph reads and writes fixed tensors, and the
temporaries are one leaf's, not the whole tree's. SGD also keeps the
reference's functional form, ``updates, state = opt.update(grads, state,
params, lr); params = apply_updates(params, updates)`` (updates are
*subtracted*; call both under ``torch.no_grad()``), for the paper
pipeline's step, which builds new tensors and copies them back.

Everything here runs on device tensors with no host sync, so it can run
inside a captured step: a schedule takes the step as an int32 tensor and
returns a device fp32 lr (``torch.where``, never a Python ``if`` on the
step); AdamW's bias corrections read its device ``count``; the clip scale
is a device tensor. A Python float lr, or an ``.item()``, would be frozen
into the graph at capture and every replay would train at that lr.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterable, Optional, Tuple

import torch

from repro_torch.core.treeutil import flatten_with_path

__all__ = ["Optimizer", "make", "sgd", "adamw", "apply_updates", "tree_map",
           "global_norm", "clip_by_global_norm_", "constant_schedule",
           "cosine_schedule", "warmup_cosine"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(*trees) -> Iterable[Tuple[torch.Tensor, ...]]:
    """The leaves of trees of one structure, zipped by path (in the first
    tree's order)."""
    flats = [flatten_with_path(t) for t in trees]
    return (tuple(f[p] for f in flats) for p in flats[0])


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update_: Callable[..., None]        # (grads, state, params, lr): in place
    # (grads, state, params, lr) -> (updates, state); SGD only
    update: Optional[Callable[..., Any]] = None


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (a 0-d tensor)."""
    total = None
    for (x,) in _leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """Scales the leaves of ``grads`` in place to a global norm of at most
    ``max_norm``; returns the norm before clipping."""
    norm = global_norm(grads)
    scale = torch.minimum(torch.ones_like(norm),
                          max_norm / torch.clamp(norm, min=1e-9))
    for (g,) in _leaves(grads):
        g.mul_(scale)
    return norm


def sgd(momentum: float = 0.9) -> Optimizer:
    """The paper's optimizer: SGD with momentum 0.9."""

    def init(params):
        return {"mu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params, lr):
        mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
        return tree_map(lambda m: lr * m, mu), {"mu": mu}

    def update_(grads, state, params, lr):
        for g, m, p in _leaves(grads, state["mu"], params):
            m.copy_(momentum * m + g)
            p.copy_(p - (lr * m).to(p.dtype))

    return Optimizer(init, update_, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
        return {"m": z, "v": tree_map(torch.zeros_like, z),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=_device(params))}

    def corrections(count):
        c = count + 1
        cf = c.to(torch.float32)
        return c, 1 - b1 ** cf, 1 - b2 ** cf

    def update_(grads, state, params, lr):
        c, bc1, bc2 = corrections(state["count"])
        for g, m, v, p in _leaves(grads, state["m"], state["v"], params):
            gf = g.to(torch.float32)
            m.copy_(b1 * m + (1 - b1) * gf)
            v.copy_(b2 * v + (1 - b2) * torch.square(gf))
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.to(torch.float32)
            p.copy_(p - (lr * u).to(p.dtype))
        state["count"].copy_(c)

    return Optimizer(init, update_)


def _device(params) -> torch.device:
    return next(iter(flatten_with_path(params).values())).device


def make(name: str, *, momentum: float = 0.9, weight_decay: float = 0.0,
         **kw) -> Optimizer:
    if name == "sgd":
        return sgd(momentum=momentum)
    if name == "adamw":
        return adamw(weight_decay=weight_decay, **kw)
    raise ValueError(f"unknown optimizer {name}")


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p - u).to(p.dtype), params, updates)


# --- schedules: step (int tensor) -> lr (fp32 tensor on its device) ---

def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_schedule(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        return lr * (final_frac + (1 - final_frac) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return fn


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = cosine_schedule(lr, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        s = _f32(step)
        w = torch.clamp(s / max(warmup, 1), max=1.0)
        return torch.where(s < warmup, lr * w, cos(s - warmup))
    return fn
