"""Collective bytes, cost and memory summaries of a trace — the port's
counterpart of the reference's ``analysis/hlo.py`` (which reads XLA's
compiled artifact; this module reads a fake-tensor op trace, see
``analysis/trace.py``). The three summaries keep the reference's keys.

``collective_bytes``: the operand bytes of every collective, by the
reference's ``KINDS``, plus ``total`` and ``count``. The collectives are
the ``_c10d_functional`` ops DTensor issues (``all_gather_into_tensor``,
``all_reduce``, ``reduce_scatter_tensor``, ``all_to_all_single``, and a
permute); their shapes are a rank's, so the bytes are per rank.

``cost_summary``: ``flops`` from ``torch.utils.flop_counter``'s formulas
and, for each kernel op, its own (registered with the op): 2 M K N for
qmatvec and qmatmul, 4 B H T S D for the attention kernels (the score and
value products over every key position, before masking); ``bytes`` the
sum of every op's input and output bytes; ``transcendentals`` the
elements of every exp / log / tanh-like op's outputs and B H T S for an
attention kernel.

``memory_summary``: ``argument_bytes`` (the storages the function was
given), ``output_bytes``, ``temp_bytes`` (the peak of what it allocated
beyond its new outputs, kernels' scratch included), ``alias_bytes`` (the
outputs that are arguments, written in place: the counterpart of donated
buffers) and ``peak_bytes_est = argument + temp + output - alias``.

Unlike XLA's cost analysis, which counts a while-loop body once, a trace
counts every layer: the dry run's reduced-depth records keep the
reference's schema all the same.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch

from repro_torch.analysis.trace import Trace, iter_ops

__all__ = ["collective_bytes", "DTYPE_BYTES", "KINDS", "cost_summary",
           "memory_summary", "collective_kind"]

# bytes per element, by torch dtype; the reference's sub-byte s4/u4 have
# no torch dtype of their own here (the port packs 3-bit codes in int32)
DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.uint16: 2, torch.bfloat16: 2, torch.float16: 2, torch.int32: 4,
    torch.uint32: 4, torch.float32: 4, torch.int64: 8, torch.uint64: 8,
    torch.float64: 8, torch.complex64: 8,
    torch.float8_e4m3fn: 1, torch.float8_e4m3fnuz: 1, torch.float8_e5m2: 1,
    torch.float8_e5m2fnuz: 1,
}

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

_KIND_OF = {"all_gather_into_tensor": "all-gather",
            "all_gather_into_tensor_coalesced": "all-gather",
            "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
            "reduce_scatter_tensor": "reduce-scatter",
            "reduce_scatter_tensor_coalesced": "reduce-scatter",
            "all_to_all_single": "all-to-all"}


def collective_kind(op_name: str):
    """The reference's collective kind of a ``_c10d_functional`` op name,
    or None for any other op."""
    ns, _, rest = op_name.partition(".")
    if ns not in ("_c10d_functional", "c10d_functional"):
        return None
    base = rest.split(".")[0]
    if "permute" in base or base in ("send", "recv"):
        return "collective-permute"
    return _KIND_OF.get(base)


def _bytes(meta) -> int:
    n = 1
    for d in meta[0]:
        n *= d
    return int(n * DTYPE_BYTES[meta[1]])


def collective_bytes(tr: Trace) -> Dict[str, float]:
    """{kind: operand bytes a rank} + ``total`` + ``count``."""
    out: Dict[str, float] = defaultdict(float)
    count = 0
    for rec in iter_ops(tr):
        kind = collective_kind(rec.name)
        if kind is None:
            continue
        out[kind] += sum(_bytes(m) for m in rec.inputs)
        count += 1
    out["total"] = sum(out[k] for k in KINDS if k in out)
    out["count"] = count
    return dict(out)


def cost_summary(tr: Trace) -> Dict[str, float]:
    return {"flops": float(sum(r.flops for r in iter_ops(tr))),
            "bytes": float(sum(r.in_bytes + r.out_bytes
                               for r in iter_ops(tr))),
            "transcendentals": float(sum(r.transcendentals
                                         for r in iter_ops(tr)))}


def memory_summary(tr: Trace) -> Dict[str, float]:
    return dict(tr.memory)
