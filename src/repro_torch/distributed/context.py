"""Sharding-constraint context — port of the reference's
``distributed/context.py``: models stay mesh-agnostic.

Step builders install a {name: spec} table (``sharding.activation_rules``
plus ``"__mesh__"``); model code calls ``constrain(x, "act")`` at the
reference's points. ``constrain`` redistributes a DTensor to the table's
placements (the counterpart of ``with_sharding_constraint``); a plain
tensor, or any tensor outside a rules context, comes back unchanged, so
one-device runs are untouched.

``cost_exact_mode`` / ``is_cost_exact`` / ``inner_unroll`` keep the
reference's flag for its cost lowerings (inner loops unrolled so a cost
analysis sees every iteration). The port's model loops are Python loops,
always unrolled, so the flag changes nothing here; the cost tooling reads
it.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

__all__ = ["sharding_rules", "constrain", "guarded", "cost_exact_mode",
           "is_cost_exact", "inner_unroll"]

_state = threading.local()


def _table() -> Optional[Dict]:
    return getattr(_state, "table", None)


@contextlib.contextmanager
def sharding_rules(table: Dict):
    prev = _table()
    _state.table = table
    try:
        yield
    finally:
        _state.table = prev


@contextlib.contextmanager
def cost_exact_mode():
    prev = getattr(_state, "cost_exact", False)
    _state.cost_exact = True
    try:
        yield
    finally:
        _state.cost_exact = prev


def is_cost_exact() -> bool:
    return getattr(_state, "cost_exact", False)


def inner_unroll() -> bool:
    """The reference's ``unroll=`` for inner scans in model code."""
    return bool(is_cost_exact())


def guarded(shape, spec, mesh) -> list:
    """The divisibility guard: ``spec``'s entry for each dim of ``shape``,
    or None where the axis has size 1 or its size does not divide the
    dim (one table serves every shape, tiny decode shapes included)."""
    from repro_torch.distributed.sharding import axis_size
    parts = list(spec) + [None] * (len(shape) - len(spec))
    return [a if a is not None and d % axis_size(mesh, a) == 0
            and axis_size(mesh, a) > 1 else None
            for d, a in zip(shape, parts)]


def constrain(x, name: str):
    """``x`` redistributed to the table's spec for ``name`` (after the
    guard, :func:`guarded`) when ``x`` is a DTensor and a rules context
    names ``name``; else ``x`` itself. A guarded spec with no axis left
    constrains nothing."""
    table = _table()
    if not table or table.get(name) is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.distributed.sharding import placements
    mesh = table.get("__mesh__")
    mesh = x.device_mesh if mesh is None else mesh
    parts = guarded(x.shape, table[name], mesh)
    if all(a is None for a in parts):
        return x
    want = placements(x.device_mesh, parts)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)
