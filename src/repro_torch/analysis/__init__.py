"""Serve-graph contract linter: static analysis over fake-tensor traces and
the kernels' launch plans — the port of the reference's
``repro/analysis``.

The paper's whole thesis is a memory contract — the working set must fit
in fast on-chip memory, which is why only 3-bit weights are used. This
package makes the port's equivalents of that contract machine-checked for
every serving graph, WITHOUT executing any of them (the graphs are traced
on fake ``"cuda"`` tensors, so no card is needed; each CUDA kernel is a
registered op, ``kernels/_ops.py``, that the trace sees with its plan):

  no_dequant            no full-shape float weight tensor materialized from
                        a quantized serve form ({"q"}/{"qp"}) outside the
                        kernel ops
  no_quadratic_scores   no (T, S)-shaped float score tensor in kernel-mode
                        prefill/verify graphs (the flash contract)
  no_host_callback      no scalar read of a device tensor, data-dependent
                        shape, copy to the host or synchronize — nothing
                        that syncs per token
  carry_dtype           every carried buffer (the tick's cache and slot
                        state) leaves the tick with its shape, dtype and
                        storage; no in-place write into one from another
                        dtype (the ``block_decode`` bf16 drift class)
  donation              the buffers the reference donates stay the
                        engine's tensors, never copied whole
  smem_budget           every launch's shared memory (the plan's dynamic
                        bytes plus the kernel's ``__shared__`` arrays)
                        within the 227 KiB a block may use on the H100 —
                        the on-chip-memory contract itself

Layers:

  trace      fake-tensor op traces and their walkers (``jaxpr_utils``)
  passes     the seven checks, each a pure function -> list[Violation]
  smem       kernel op -> shared-memory footprint; ptxas's report (``vmem``)
  contracts  the contract-point registry (decode tick, bucketed prefill,
             spec tick, admit, verify, generate loop) + the family x form x
             mode sweep + the engine's capture budgets
  costs      collective bytes, cost and memory summaries of a trace
             (``hlo``; ``repro_torch.launch.hlo_analysis`` re-exports it)

Run the sweep: ``python -m repro_torch.analysis --check`` (JSON report;
exits 1 on a violation).
"""
from repro_torch.analysis import costs  # noqa: F401
from repro_torch.analysis.passes import (  # noqa: F401
    Violation,
    check_carry_fixed_point,
    check_donation,
    check_no_dequant,
    check_no_host_callback,
    check_no_quadratic_scores,
    check_scan_carries,
    check_smem_budget,
)
from repro_torch.analysis.smem import DEFAULT_SMEM_BUDGET  # noqa: F401
from repro_torch.analysis.contracts import (  # noqa: F401
    capture_report,
    forbidden_dequant_shapes,
    lint_combo,
    run_sweep,
)
from repro_torch.analysis.trace import trace  # noqa: F401

__all__ = [
    "Violation", "check_no_dequant", "check_no_quadratic_scores",
    "check_no_host_callback", "check_carry_fixed_point", "check_donation",
    "check_scan_carries", "check_smem_budget", "forbidden_dequant_shapes",
    "lint_combo", "run_sweep", "capture_report", "DEFAULT_SMEM_BUDGET",
    "costs", "trace",
]
