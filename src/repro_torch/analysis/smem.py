"""Per-launch shared-memory footprint of the hand-written kernels — the
port's counterpart of the reference's ``analysis/vmem.py``.

The paper's on-chip-memory contract, stated in bytes for the H100: a
block's working set in shared memory — the dynamic shared memory its
launch asks for plus the kernel's ``__shared__`` arrays — must fit the
227 KiB one block may use, or the launch fails; and the blocks an SM holds
at once (228 KiB an SM, 1 KiB of it kept by the runtime for each block)
set how many of the grid's blocks run together.

The estimate is read off a kernel op of a trace alone, nothing executed:
the dynamic bytes are the plan's (``kernels/*/kernel.py``, the same plan
the CUDA implementation launches with), the static bytes the constants
below, one per CUDA function, which :func:`ptxas_entries` checks against
what ptxas reports on the card.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List

from repro_torch.kernels._ops import BLOCK_RESERVED, SM_SMEM

__all__ = ["DEFAULT_SMEM_BUDGET", "SM_SMEM", "BLOCK_RESERVED",
           "STATIC_SMEM", "launch_functions", "kernel_smem_estimate",
           "blocks_per_sm", "ptxas_entries", "ptxas_summary"]

# shared memory one block may use on the H100 (cudaFuncSetAttribute's
# ceiling): the on-chip contract every launch must meet
DEFAULT_SMEM_BUDGET = 227 * 1024
_MAX_BLOCKS_PER_SM = 32

# static shared memory (``__shared__`` arrays) by CUDA function, as ptxas
# lays it out (``-Xptxas -v``'s "bytes smem", checked on the card by
# chip_smoke.py's analysis phase); every function not named here has none
STATIC_SMEM = {
    # csrc/attn_decode.cu:359-360: float wsp[MAX_SPLITS = 1024] and float
    # den, 4100 B declared; ptxas places den at the next 16 bytes
    "attn_decode_kernel_combine": 4112,
    # csrc/attn_prefill_tc.cu:241: int red[2][4], 32 B declared; ptxas
    # reserves 128 (the block's shared memory aligned to 128 for wgmma)
    "attn_prefill_kernel_wgmma": 128,
    # csrc/qmatmul.cu:863: float part[KN_THREADS / 32 = 8][KN_COLS = 16]
    "qmatmul_kernel_klanes_narrow": 8 * 16 * 4,
}


def launch_functions(note: Dict[str, Any]) -> List[tuple]:
    """The CUDA functions one launch runs, as ``(function, dynamic shared
    bytes)``: the main kernel with the plan's dynamic shared memory, then
    a K-split's sum, a split's merge, each with none."""
    kernel, variant, plan = note["kernel"], note["variant"], note["plan"]
    dyn = note["dynamic_smem"]
    if kernel == "qmatvec":
        out = [(f"qmatvec_kernel_{variant}", dyn)]
        if plan.ksplit > 1:
            out.append((f"qmatvec_kernel_{variant}_sum", 0))
        return out
    if kernel == "qmatmul":
        layout, sub = variant.split("/")
        if layout == "k_lanes":
            return [("qmatmul_kernel_klanes" if sub == "k_major"
                     else "qmatmul_kernel_klanes_narrow", dyn)]
        out = [(f"qmatmul_kernel_nlanes_{sub}", dyn)]
        if plan.ksplit > 1:
            out.append(("qmatmul_kernel_nlanes_sum", 0))
        return out
    if kernel == "attn_decode":
        return [("attn_decode_kernel_split", dyn),
                ("attn_decode_kernel_combine", 0)]
    if kernel == "attn_prefill":
        if variant == "wgmma":
            return [("attn_prefill_kernel_wgmma", dyn)]
        out = [("attn_prefill_kernel", dyn)]
        if plan.splits > 1:
            out.append(("attn_prefill_kernel_merge", 0))
        return out
    return [("sigmoid_pw_kernel", dyn)]


def blocks_per_sm(smem_bytes: int) -> int:
    """Blocks of this much shared memory one SM holds at once (the other
    limits, registers and threads, aside)."""
    return min(_MAX_BLOCKS_PER_SM, SM_SMEM // (smem_bytes + BLOCK_RESERVED))


def kernel_smem_estimate(rec) -> Dict[str, Any]:
    """One kernel op's on-chip footprint: ``{name, variant, grid,
    dynamic_bytes, static_bytes, smem_bytes, blocks_per_sm, functions}``
    for its main kernel (``smem_bytes`` = dynamic + static), with
    ``functions`` itemizing every CUDA function of the launch as
    ``(function, dynamic, static)``."""
    note = rec.kernel
    fns = [(f, d, STATIC_SMEM.get(f, 0)) for f, d in launch_functions(note)]
    main, dyn, static = fns[0]
    return {"name": note["kernel"], "variant": note["variant"],
            "function": main, "grid": note["grid"], "dynamic_bytes": dyn,
            "static_bytes": static, "smem_bytes": dyn + static,
            "blocks_per_sm": blocks_per_sm(dyn + static),
            "functions": fns}


# --- ptxas's report ------------------------------------------------------------------

def _demangled_name(mangled: str) -> str:
    """The function's own name from an Itanium-mangled one: ``_Z`` then
    its length and its characters (``_Z21qmatvec_kernel_decodeI...``)."""
    m = re.match(r"_Z(\d+)", mangled)
    if m:
        start = m.end()
        return mangled[start:start + int(m.group(1))]
    m = re.search(r"[a-z_]*_kernel[a-z_]*", mangled)
    return m.group(0) if m else mangled


def ptxas_entries(log: str) -> List[Dict[str, Any]]:
    """One entry per compiled CUDA function from nvcc's ``-Xptxas -v``
    output: its name (the function, template arguments dropped), the
    mangled name, registers, spill stores and loads and static shared
    bytes (``bytes smem``)."""
    out: List[Dict[str, Any]] = []
    cur = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = {"function": _demangled_name(m.group(1)),
                   "mangled": m.group(1), "spill": None}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            cur["spill"] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = int(sm.group(1)) if sm else 0
            out.append(cur)
            cur = None
    return out


def ptxas_summary(log: str) -> List[str]:
    """One line per compiled CUDA function: its name, registers, spill
    bytes (stores/loads) and static shared bytes."""
    lines = []
    for e in ptxas_entries(log):
        spill = ("None" if e["spill"] is None
                 else f"{e['spill'][0]}/{e['spill'][1]} B spill")
        lines.append(f"{e['function']}: {e['registers']} regs, {spill}, "
                     f"{e['smem']} B smem")
    return lines
