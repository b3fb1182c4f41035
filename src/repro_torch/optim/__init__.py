"""Optimizers on dicts of tensors: SGD with momentum, the paper's trainer
(§2.1: lr 0.1/0.05, momentum 0.9).

Port of the SGD part of the reference's ``optim``, with its functional
protocol: ``opt = sgd(...); state = opt.init(params);
updates, state = opt.update(grads, state, params, lr);
params = apply_updates(params, updates)`` — updates are *subtracted*. Call
``update`` and ``apply_updates`` under ``torch.no_grad()``; they build new
tensors and leave their inputs as they were.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

__all__ = ["Optimizer", "sgd", "apply_updates", "tree_map"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]          # (grads, state, params, lr) -> (updates, state)


def sgd(momentum: float = 0.9) -> Optimizer:
    """The paper's optimizer: SGD with momentum 0.9."""

    def init(params):
        return {"mu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params, lr):
        mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
        return tree_map(lambda m: lr * m, mu), {"mu": mu}

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p - u).to(p.dtype), params, updates)
