"""The hand-written kernels as registered torch ops, ``torch.ops.repro_torch.*``.

Each kernel's CUDA entry point is one op of the ``repro_torch`` library with
two implementations and no other:

- ``CUDA``: the kernel's ``ctypes`` launch (``<kernel>/kernel.py``), which
  alone touches the CUDA runtime (the build, the stream, the device);
- a fake implementation (``torch.library.register_fake``): allocates what
  the launch allocates — the output and the launch's scratch, with their
  shapes, dtypes, devices and strides — and computes nothing.

No CPU implementation is registered: a real CPU tensor that reaches an op
is a dispatcher error, never a silent plain version (``ops.py`` picks the
plain version for a CPU tensor before any op is called). Under
``FakeTensorMode`` an op appears in a dispatch trace by name
(``repro_torch.qmatvec.default``), so ``repro_torch.analysis`` sees every
launch of a serving graph without a card.

Both implementations call :func:`note` with the launch's plan (variant,
grid, dynamic shared memory) and its scratch; a :func:`recording` context
collects those notes, so a trace knows the plan that the real launch would
use. No kernel writes into a tensor it is given, so no op declares a
mutated argument. The launch counters stay in the CUDA implementations:
they count real launches only.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

__all__ = ["LIB", "NAMESPACE", "define", "note", "recording", "op",
           "register_all", "OP_NAMES", "Note", "SM_SMEM", "BLOCK_RESERVED"]

# the H100's shared memory: an SM's, and what the runtime keeps for each
# resident block (the launch plans and analysis/smem.py read them)
SM_SMEM = 228 * 1024
BLOCK_RESERVED = 1024

NAMESPACE = "repro_torch"
LIB = torch.library.Library(NAMESPACE, "DEF")
OP_NAMES: List[str] = []

Note = Dict[str, Any]
_recorders: List[List[Note]] = []


def define(name: str, schema: str, cuda_impl: Callable, fake_impl: Callable,
           flops: Optional[Callable] = None) -> None:
    """Register op ``repro_torch::<name>(<schema>)`` with its CUDA and fake
    implementations and, where given, its flop formula for
    ``torch.utils.flop_counter.FlopCounterMode`` (called with the inputs'
    shapes and ``out_shape``)."""
    LIB.define(f"{name}{schema}")
    LIB.impl(name, cuda_impl, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake_impl, lib=LIB)
    if flops is not None:
        from torch.utils.flop_counter import register_flop_formula
        register_flop_formula(getattr(torch.ops.repro_torch, name))(flops)
    OP_NAMES.append(name)


def register_all() -> List[str]:
    """Import every kernel's launch module, which registers its ops;
    returns the op names."""
    import importlib
    for k in ("qmatvec", "qmatmul", "attn_decode", "attn_prefill",
              "sigmoid_pw"):
        importlib.import_module(f"repro_torch.kernels.{k}.kernel")
    return list(OP_NAMES)


def op(name: str):
    """The registered op ``torch.ops.repro_torch.<name>.default``."""
    return getattr(torch.ops.repro_torch, name).default


def note(kernel: str, variant: str, grid, dynamic_smem: int,
         scratch=(), plan=None) -> None:
    """Hand one launch's plan to every open :func:`recording`: the kernel,
    its variant (``""`` where it has one), the main kernel's grid, its
    dynamic shared memory in bytes and the scratch tensors the launch
    allocates as ``(shape, dtype)``."""
    if not _recorders:
        return
    rec = {"kernel": kernel, "variant": variant,
           "grid": tuple(int(g) for g in grid),
           "dynamic_smem": int(dynamic_smem),
           "scratch": [(tuple(int(d) for d in s), dt) for s, dt in scratch],
           "plan": plan}
    for r in _recorders:
        r.append(rec)


@contextlib.contextmanager
def recording() -> Iterator[List[Note]]:
    """Collect the :func:`note` of every kernel op called inside."""
    notes: List[Note] = []
    _recorders.append(notes)
    try:
        yield notes
    finally:
        _recorders.remove(notes)
