"""``python -m repro_torch.analysis``: sweep the serve-graph contracts.

Traces every family x serve-form x mode contract point on fake tensors
(no card needed: the kernels are registered ops the trace sees), runs the
passes, and writes a JSON report. ``--check`` exits non-zero on any
violated contract.

    python -m repro_torch.analysis --check --out analysis_report.json
    python -m repro_torch.analysis --families dense hybrid --modes kernel
    python -m repro_torch.analysis --check --exercise   # + capture budgets
                                                        # (needs a card)
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from repro_torch.analysis import contracts


def _exercise_captures():
    """One micro serve (dense / qp / kernel, speculative) on the card, so
    the capture budgets in the report come from real CUDA-graph captures:
    the tick captures once, the one admission bucket used once."""
    if not torch.cuda.is_available():
        raise SystemExit("--exercise serves on a CUDA card; none is "
                         "available")
    from repro_torch.serving.engine import ServingEngine
    cfg, sp, _ = contracts._serve_setup("dense", "qp")
    eng = ServingEngine(sp, cfg, policy=contracts.W3, slots=contracts.SLOTS,
                        max_len=contracts.MAX_LEN, dtype=torch.float32,
                        attn_chunk=contracts.MAX_LEN,
                        spec_k=contracts.SPEC_K, matmul_mode="kernel",
                        attn_mode="kernel", device="cuda")
    for _ in range(3):
        eng.submit([1, 2, 3, 4], max_new=5)
    eng.step()
    eng.submit([4, 3, 2, 1], max_new=5)       # late wave, same bucket
    eng.run_all()
    return contracts.capture_report(eng, {"tick": 1, "admit": 1})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static serve-graph contract linter over fake-tensor "
                    "traces (see README 'Static analysis & graph "
                    "contracts').")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if any contract is violated")
    ap.add_argument("--families", nargs="+", default=list(contracts.FAMILIES),
                    choices=list(contracts.FAMILIES))
    ap.add_argument("--forms", nargs="+", default=list(contracts.FORMS),
                    choices=list(contracts.FORMS))
    ap.add_argument("--modes", nargs="+", default=list(contracts.MODES),
                    choices=list(contracts.MODES))
    ap.add_argument("--smem-budget", type=int,
                    default=contracts.DEFAULT_SMEM_BUDGET,
                    help="shared memory a block may use, in bytes "
                         "(default: %(default)s, one H100 block)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device of the fake tensors (default cuda: "
                         "the card's graphs, with their kernel ops; on cpu "
                         "every kernel takes its plain version)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the JSON report here")
    ap.add_argument("--exercise", action="store_true",
                    help="also serve once on the card and report its CUDA "
                         "graph captures against budgets")
    args = ap.parse_args(argv)

    report = contracts.run_sweep(
        args.families, args.forms, args.modes,
        smem_budget=args.smem_budget, device=args.device,
        progress=lambda combo: print(f"  lint {combo}", flush=True))
    if args.exercise:
        print("  exercise dense/qp/kernel (spec) for capture counts",
              flush=True)
        report["captures"] = _exercise_captures()

    n_viol = report["violations"] + len(
        report.get("captures", {}).get("violations", []))
    for combo in report["combos"]:
        for rec in combo["points"]:
            for name, viols in rec["checks"].items():
                for v in viols:
                    print(f"VIOLATION {combo['family']}/{combo['form']}/"
                          f"{combo['mode']} {rec['point']}: {v['check']}: "
                          f"{v['message']}"
                          + (f" [at: {v['eqn']}]" if v.get("eqn") else ""))
    for v in report.get("captures", {}).get("violations", []):
        print(f"VIOLATION captures: {v['message']}")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, default=str)
        print(f"report -> {args.out}")
    print(f"{report['checks']} checks across "
          f"{len(report['combos'])} combos: {n_viol} violation(s)")
    return 1 if (args.check and n_viol) else 0


if __name__ == "__main__":
    sys.exit(main())
