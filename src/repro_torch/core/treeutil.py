"""Small nested-dict tree helpers (pure-dict param trees), the JAX-free part
of the reference's ``core/treeutil.py``."""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

__all__ = ["map_with_path", "tree_map", "flatten_with_path", "unflatten",
           "tree_get",
           "tree_set", "tree_write_", "role_of", "tree_size", "tree_nbytes",
           "any_nan"]


def map_with_path(fn: Callable[[str, Any], Any], tree: Any, _prefix: str = "") -> Any:
    """Map ``fn(path, leaf)`` over a nested-dict tree; preserves structure.
    ``None`` leaves map to ``None``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{_prefix}/{k}" if _prefix else k)
                for k, v in tree.items()}
    if tree is None:
        return None
    return fn(_prefix, tree)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Map ``fn(leaf, *leaves)`` over a nested-dict tree and the leaves at
    the same places of ``rest`` (trees with at least its keys); preserves
    ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def flatten_with_path(tree: Any, _prefix: str = "") -> Dict[str, Any]:
    """Flatten a nested-dict tree into {path: leaf} (skips None leaves)."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_with_path(v, f"{_prefix}/{k}" if _prefix else k))
    elif tree is not None:
        out[_prefix] = tree
    return out


def unflatten(flat: Dict[str, Any]) -> Any:
    """Inverse of :func:`flatten_with_path`."""
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def tree_get(tree: Any, path: str) -> Any:
    """Leaf at a ``flatten_with_path``-style '/'-joined path. KeyError names
    the missing path segment."""
    node = tree
    for p in path.split("/"):
        if not isinstance(node, dict) or p not in node:
            raise KeyError(f"no leaf at {path!r} (missing {p!r})")
        node = node[p]
    return node


def tree_set(tree: Any, path: str, value: Any) -> Any:
    """Functional single-leaf update: a new tree with ``path`` replaced by
    ``value``. Only the dicts along the path are copied (siblings shared).
    The path must already exist (this repairs leaves, it does not grow
    trees)."""
    parts = path.split("/")
    tree_get(tree, path)                      # validate before copying
    out = dict(tree)
    node = out
    for p in parts[:-1]:
        node[p] = dict(node[p])
        node = node[p]
    node[parts[-1]] = value
    return out


def tree_write_(tree: Any, path: str, value: Any) -> torch.Tensor:
    """In-place single-leaf update: ``value`` is copied into the storage of
    the tensor at ``path`` (same shape, in its logical order, whatever its
    strides), so code that holds that tensor by address — a captured CUDA
    graph — reads the new contents. Returns the leaf."""
    leaf = tree_get(tree, path)
    value = torch.as_tensor(value)
    if tuple(value.shape) != tuple(leaf.shape):
        raise ValueError(f"tree_write_ {path!r}: shape {tuple(value.shape)} "
                         f"!= leaf shape {tuple(leaf.shape)}")
    with torch.no_grad():
        leaf.copy_(value)
    return leaf


def tree_size(tree: Any) -> int:
    """Total number of elements across all tensor leaves."""
    return sum(x.numel() for x in flatten_with_path(tree).values())


def tree_nbytes(tree: Any) -> int:
    return sum(x.numel() * x.element_size()
               for x in flatten_with_path(tree).values())


# --- role inference from parameter path (see precision.py role table) --------

_OUTPUT_MARKERS = ("head", "unembed", "logits", "w_out_layer", "output_layer")
_EMBED_MARKERS = ("embed",)
_ROUTER_MARKERS = ("router", "gate_w")
_SSM_MARKERS = ("a_log", "dt_bias", "dt_w", "conv", "ssm_d")
_SKIP_MARKERS = ("norm", "scale", "/b", "bias", "ln_", "rope")


def role_of(path: str) -> str:
    """Infer the quantization role of a weight from its tree path."""
    p = path.lower()
    if any(m in p for m in _SSM_MARKERS):
        return "ssm"
    if any(m in p for m in _SKIP_MARKERS) or p.endswith("/b") or p.endswith("bias"):
        return "bias"
    if any(m in p for m in _ROUTER_MARKERS):
        return "router"
    if any(m in p for m in _OUTPUT_MARKERS):
        return "output"
    if any(m in p for m in _EMBED_MARKERS):
        return "embed"
    return "hidden"


def any_nan(tree: Any) -> bool:
    return any(bool(torch.isnan(x).any())
               for x in flatten_with_path(tree).values()
               if x.is_floating_point())
