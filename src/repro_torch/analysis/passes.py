"""The seven contract passes — the port's counterpart of the reference's
``analysis/passes.py``. Each is a pure function over a :class:`Trace`
(``analysis/trace.py``: a fake-tensor op trace, nothing executed) and
returns a list of :class:`Violation` — empty means the contract holds.

Check names are the reference's (``no_dequant``, ``no_quadratic_scores``,
``no_host_callback``, ``carry_dtype``, ``donation``) so that the two
reports diff; ``smem_budget`` is ``vmem_budget`` for the H100's shared
memory, and ``scan_carries`` the torch form of the reference's carry
drift: the port's ticks write their carried buffers in place, so a drift
is an in-place write from a source of another dtype (a silent cast).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List

from repro_torch.analysis.smem import (DEFAULT_SMEM_BUDGET,
                                       kernel_smem_estimate)
from repro_torch.analysis.trace import (Trace, find_kernel_ops,
                                        float_shapes_outside_kernels,
                                        iter_ops, op_label)

__all__ = ["Violation", "check_no_dequant", "check_no_quadratic_scores",
           "check_no_host_callback", "check_scan_carries",
           "check_carry_fixed_point", "check_donation", "check_smem_budget"]


@dataclasses.dataclass
class Violation:
    """One broken contract: which pass fired, an actionable message, and
    (when attributable) the offending op's label (``eqn``, the
    reference's field name)."""
    check: str
    message: str
    eqn: str = ""

    def __str__(self) -> str:
        loc = f" [at: {self.eqn}]" if self.eqn else ""
        return f"{self.check}: {self.message}{loc}"

    def to_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)


# --- pass 1: no dequantized weight tensor -----------------------------------------

def check_no_dequant(tr: Trace, forbidden_shapes: Iterable[tuple], *,
                     require_kernel: bool = True) -> List[Violation]:
    """No float tensor of a quantized weight's (stacked or per-layer)
    shape outside the kernel ops: a hit means the graph materialized a
    dequantized weight matrix in device memory — what the 3-bit serve
    forms exist to avoid. ``require_kernel`` also demands that the graph
    ran a ``repro_torch`` kernel op at all (a kernel mode that fell back
    to a plain path is itself a violation)."""
    shapes, saw = float_shapes_outside_kernels(tr)
    forbidden = set(map(tuple, forbidden_shapes))
    out = [Violation("no_dequant",
                     f"float tensor of quantized-weight shape {sh} is "
                     f"materialized outside the kernel ops (dequantized "
                     f"weight in the serve graph)", eqn=shapes[sh])
           for sh in sorted(set(shapes) & forbidden)]
    if require_kernel and not saw:
        out.append(Violation("no_dequant",
                             "graph contains no repro_torch kernel op: "
                             "kernel mode did not reach the CUDA kernels"))
    return out


# --- pass 2: no quadratic score tensor --------------------------------------------

def check_no_quadratic_scores(tr: Trace, t: int, s: int, *,
                              min_rank: int = 2,
                              require_kernel: bool = False
                              ) -> List[Violation]:
    """No float tensor whose trailing dims are (T, S) outside the kernel
    ops of a kernel-mode prefill / verify graph: the blocked online
    softmax keeps its score tile in shared memory and registers, so a full
    (..., T, S) float result means the quadratic intermediate is back in
    device memory."""
    shapes, saw = float_shapes_outside_kernels(tr)
    out = [Violation("no_quadratic_scores",
                     f"float score tensor {sh} with trailing dims "
                     f"(T={t}, S={s}) materialized outside the kernel ops "
                     f"(quadratic intermediate in device memory)",
                     eqn=shapes[sh])
           for sh in sorted(shapes)
           if len(sh) >= max(2, min_rank) and tuple(sh[-2:]) == (t, s)]
    if require_kernel and not saw:
        out.append(Violation("no_quadratic_scores",
                             "graph contains no repro_torch kernel op: "
                             "kernel mode did not reach the CUDA kernels"))
    return out


# --- pass 3: no host sync / transfer ----------------------------------------------

def check_no_host_callback(tr: Trace) -> List[Violation]:
    """No op that syncs with or copies to the host: a scalar read of a
    device tensor (``aten._local_scalar_dense``), an op whose output
    shape depends on the data (``nonzero``), a copy to a CPU tensor, and
    no ``torch.cuda.synchronize`` / ``Stream.synchronize`` /
    ``Event.synchronize`` called. Any of them stalls the tick on the host
    every token (and cannot be captured in a CUDA graph)."""
    out = [Violation("no_host_callback",
                     f"host-sync op '{rec.name}' in a serving graph: "
                     f"{rec.host_sync} (breaks the async "
                     f"no-per-token-sync contract)", eqn=op_label(rec))
           for rec in iter_ops(tr) if rec.host_sync]
    out += [Violation("no_host_callback",
                      f"'{name}' called inside a serving graph (breaks the "
                      f"async no-per-token-sync contract)")
            for name in tr.syncs]
    return out


# --- pass 4: carried buffers stay fixed points --------------------------------------

def _sig_str(sig) -> str:
    return f"{str(sig[1]).replace('torch.', '')}{list(sig[0])}"


def check_carry_fixed_point(tr: Trace, *, point: str = ""
                            ) -> List[Violation]:
    """Every carried tensor (the trace's ``carry``) leaves the point with
    the shape and dtype it came in with, and as the same storage: the
    port's ticks write their state in place (a captured graph reads and
    writes fixed addresses), so a carried leaf that changes dtype, shape
    or storage breaks the next replay — the ``block_decode`` bf16
    drift class."""
    label = point or "fn"
    viols: List[Violation] = []
    for name in sorted(tr.carry_before):
        before = tr.carry_before.get(name, {})
        after = tr.carry_after.get(name, {})
        if set(before) != set(after):
            viols.append(Violation(
                "carry_dtype", f"{label}: carried '{name}' changed its "
                f"tree structure across the tick"))
            continue
        for path in sorted(before):
            a, b = before[path], after[path]
            if a[:2] != b[:2]:
                viols.append(Violation(
                    "carry_dtype",
                    f"{label}: carried {path} is {_sig_str(a)} going in but "
                    f"{_sig_str(b)} coming out — not a fixed point, so the "
                    f"next tick reads another tensor than the last wrote"))
            elif a[2] != b[2]:
                viols.append(Violation(
                    "carry_dtype",
                    f"{label}: carried {path} ({_sig_str(a)}) is a new "
                    f"tensor after the tick, not the one written in place "
                    f"(a captured graph would keep reading the old one)"))
    return viols


def check_scan_carries(tr: Trace) -> List[Violation]:
    """No in-place write (``copy_``, ``index_put_``, ``add_`` …) into a
    carried buffer (a storage the trace's ``carry`` names) from a tensor
    of another dtype: the write casts silently, so a state kept in bf16
    drifts from the fp32 it was computed in (the ``block_decode``
    conv-state drift)."""
    carried = {sig[2] for leaves in tr.carry_before.values()
               for sig in leaves.values() if sig[2] is not None}
    out = []
    for rec in iter_ops(tr):
        for key, shape, dtype, srcs in rec.writes:
            if key not in carried:
                continue
            bad = sorted({str(s).replace("torch.", "") for s in srcs
                          if s != dtype})
            if bad:
                out.append(Violation(
                    "carry_dtype",
                    f"in-place write into a carried "
                    f"{str(dtype).replace('torch.', '')}{list(shape)} "
                    f"buffer from {', '.join(bad)}: a silent cast of the "
                    f"carried state every step", eqn=op_label(rec)))
    return out


# --- pass 5: donation honored -----------------------------------------------------

def check_donation(tr: Trace, donated: Iterable[str], *, point: str = ""
                   ) -> List[Violation]:
    """The buffers the reference donates (``donated``: names of the
    trace's ``carry``) stay the engine's tensors — the same storage after
    the point — and no op reads a donated leaf whole into a fresh tensor
    of its whole shape and dtype (``clone``, ``where`` over the buffer,
    an out-of-place update): the copy of the buffer that the reference's
    donation exists to avoid. The copy test covers the leaves of rank 2
    and above, the K/V and recurrent states: a per-slot length vector is
    recomputed whole every tick by design."""
    label = point or "fn"
    viols: List[Violation] = []
    whole = {}
    for name in donated:
        for path, sig in tr.carry_before.get(name, {}).items():
            after = tr.carry_after.get(name, {}).get(path)
            if after is None or after[2] != sig[2]:
                viols.append(Violation(
                    "donation", f"{label}: donated {path} is not the same "
                    f"tensor after the call (the buffer was replaced, not "
                    f"updated in place)"))
            if len(sig[0]) >= 2:
                whole[(sig[2], tuple(sig[0]), sig[1])] = path
    for rec in iter_ops(tr):
        read = [whole.get((key, tuple(m[0]), m[1]))
                for key, m in zip(rec.in_storage, rec.inputs)]
        for path in filter(None, read):
            shape, dtype = next((m[0], m[1]) for m, p in
                                zip(rec.inputs, read) if p == path)
            if any(fresh and (tuple(o[0]), o[1]) == (tuple(shape), dtype)
                   for o, fresh in zip(rec.outputs, rec.new_storage)):
                viols.append(Violation(
                    "donation",
                    f"{label}: donated {path} is copied whole into a fresh "
                    f"tensor of its shape and dtype (a copy of the buffer "
                    f"every call, not an update in place)",
                    eqn=op_label(rec)))
    return viols


# --- pass 6: shared-memory budget -------------------------------------------------

def check_smem_budget(tr: Trace, budget_bytes: int = DEFAULT_SMEM_BUDGET
                      ) -> List[Violation]:
    """Every CUDA function a kernel op launches asks for at most
    ``budget_bytes`` of shared memory a block (dynamic + static, see
    :func:`repro_torch.analysis.smem.kernel_smem_estimate`): the paper's
    on-chip-memory contract in bytes."""
    out = []
    for rec in find_kernel_ops(tr):
        est = kernel_smem_estimate(rec)
        for fn, dyn, static in est["functions"]:
            if dyn + static > budget_bytes:
                out.append(Violation(
                    "smem_budget",
                    f"kernel '{est['name']}' ({fn}, grid {est['grid']}) "
                    f"asks for {dyn + static} B of shared memory a block "
                    f"(dynamic {dyn} + static {static}), over the budget "
                    f"of {budget_bytes} B", eqn=op_label(rec)))
    return out
