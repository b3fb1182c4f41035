"""The contract-point registry and the family x form x mode sweep — the
port's counterpart of the reference's ``analysis/contracts.py``.

A contract point is one graph body the engine runs — decode tick,
bucketed prefill admission, speculative tick, multi-slot admit — plus the
model-level ``verify_step`` and the module-level ``generate`` loop.
Engines describe their own points (``ServingEngine.contract_points``);
this module builds reduced configs for every family, builds each engine
on fake ``"cuda"`` tensors (``capture=False``), traces each point
(``analysis/trace.py``: nothing executes, no card needed) and runs the
passes that apply:

  kernel mode      no_dequant (clean, and at least one kernel op),
                   no_quadratic_scores (full-attention prefill + verify),
                   smem_budget, no_host_callback, carry_dtype, donation
  fallback mode    the SAME dequant / score detectors must TRIP (the
                   fallback graphs are the reference signal — if they stop
                   tripping, the kernel-mode checks are vacuous), plus
                   no_host_callback / carry_dtype / donation, which hold
                   in every mode.

The quadratic-score pass applies to full-attention prefill only
(dense / moe): the SSD chunked scan (ssm, hybrid's mamba groups) builds an
intra-chunk (c, c) masked matmul by design. Verify (spec_tick) is checked
for every attention-bearing family.

On a CPU device (``device="cpu"``) every kernel wrapper takes its plain
version (``kernels/*/ops.py`` dispatches on the device), so a kernel-mode
graph there has no kernel op: only the checks that hold in every mode run.

``capture_report`` is the counterpart of ``retrace_report``: a healthy
engine captures its tick once and each admission bucket once.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.analysis import passes
from repro_torch.analysis.smem import (DEFAULT_SMEM_BUDGET,
                                       kernel_smem_estimate)
from repro_torch.analysis.trace import (fake_mode, fake_tree,
                                        find_kernel_ops, trace)
from repro_torch.configs import get_config, reduced
from repro_torch.core import quant_dense
from repro_torch.core.precision import W3A8
from repro_torch.core.treeutil import flatten_with_path, role_of

__all__ = ["FAMILIES", "FORMS", "MODES", "ARCH_FOR", "DEFAULT_SMEM_BUDGET",
           "SLOTS", "MAX_LEN", "SPEC_K", "forbidden_dequant_shapes",
           "contract_points", "lint_combo", "run_sweep", "capture_report"]

# weight-only 3-bit: the serve policy every registry graph is linted under
W3 = dataclasses.replace(W3A8, act_bits=None)

FAMILIES = ("dense", "moe", "ssm", "hybrid")
FORMS = ("q", "qp")
MODES = ("kernel", "fallback")

ARCH_FOR = {"dense": "qwen2-1.5b", "moe": "phi3.5-moe-42b-a6.6b",
            "ssm": "mamba2-2.7b", "hybrid": "zamba2-1.2b"}

# registry engine geometry: tiny but exercising every path. MAX_LEN (48)
# is distinct from the reduced vocab (64) and d_model (32) so the (T, S)
# score predicate can't collide with logits or residuals
SLOTS, MAX_LEN, SPEC_K = 2, 48, 2


def forbidden_dequant_shapes(float_params, policy=W3) -> set:
    """Shapes a dequantized weight matrix would have in a serve graph:
    each quantizable leaf's full (stacked) shape and its per-layer
    slice."""
    shapes = set()
    for path, leaf in flatten_with_path(float_params).items():
        if not (path.endswith("/w") or path == "w"):
            continue
        if policy.spec_for(role_of(path)) is None:
            continue
        nd = quant_dense._stacked_dims(path)
        shapes.add(tuple(leaf.shape))
        shapes.add(tuple(leaf.shape[nd:]))
    return shapes


def family_config(family: str):
    """The registry's reduced config of ``family``: the reference's (2
    layers; hybrid 4, two groups; d_model 32, vocab 64) with head_dim 16
    in place of its 8 — the smallest the attention kernels take (a wgmma
    k-step). Heads and KV heads stay the reference's, so every point runs
    the reference's kernels, as many times."""
    layers = 4 if family == "hybrid" else 2
    cfg = reduced(get_config(ARCH_FOR[family]), layers=layers, d_model=32,
                  vocab=64)
    if cfg.num_heads:
        cfg = dataclasses.replace(cfg, head_dim=max(cfg.head_dim, 16))
    return cfg


@functools.lru_cache(maxsize=None)
def _family_setup(family: str):
    from repro_torch.models import get_model
    cfg = family_config(family)
    params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg)
    return cfg, params


@functools.lru_cache(maxsize=None)
def _serve_setup(family: str, form: str):
    cfg, params = _family_setup(family)
    export = (quant_dense.export_levels if form == "q"
              else quant_dense.export_container)
    return cfg, export(params, W3), params


def _mode_kwargs(mode: str) -> Dict[str, str]:
    return (dict(matmul_mode="kernel", attn_mode="kernel") if mode == "kernel"
            else dict(matmul_mode="dequant", attn_mode="ref"))


def trace_device(device) -> torch.device:
    """``device`` with an index: a fake ``.to("cuda")`` asks the CUDA
    runtime for the current device, which a build without CUDA lacks;
    ``.to("cuda:0")`` does not."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    return device


def _engine(family: str, form: str, mode: str, *, spec: bool,
            device="cuda"):
    """A registry engine on fake tensors (built under the mode it
    returns with it)."""
    from repro_torch.serving.engine import ServingEngine
    cfg, sp, _ = _serve_setup(family, form)
    fm = fake_mode()
    sp = fake_tree(sp, fm, device)
    with fm:
        eng = ServingEngine(sp, cfg, policy=W3, slots=SLOTS, max_len=MAX_LEN,
                            dtype=torch.float32, attn_chunk=MAX_LEN,
                            spec_k=SPEC_K if spec else 0, capture=False,
                            device=device, **_mode_kwargs(mode))
    return eng, fm


def _scores_apply(family: str, point: str) -> bool:
    if point == "prefill_bucketed":
        return family in ("dense", "moe")     # full-attention prefill only
    if point == "spec_tick":
        return family != "ssm"
    return False


def _verify_point(family: str, form: str, mode: str, device, fm
                  ) -> Optional[Dict]:
    """Model-level multi-token verify over a live cache — the point
    threaded through ``models/api.py``."""
    from repro_torch.models import api as model_api
    if family == "ssm":
        return None
    cfg, sp, _ = _serve_setup(family, form)
    mod = model_api.get_model(cfg)
    t = SPEC_K + 1
    s = (mod.cache_len_for(cfg, MAX_LEN)
         if hasattr(mod, "cache_len_for") else MAX_LEN)
    params = fake_tree(sp, fm, device)
    with fm:
        cache = model_api.init_cache(cfg, SLOTS, MAX_LEN, torch.float32,
                                     per_slot_len=True, device=device)
        toks = torch.zeros((SLOTS, t), dtype=torch.int32, device=device)
    mkw = _mode_kwargs(mode)

    def fn():
        return model_api.verify_step(params, cache, toks, cfg, policy=W3,
                                     dtype=torch.float32, **mkw)
    return dict(name="verify", fn=fn,
                inputs={"params": params, "cache": cache, "tokens": toks},
                carry={}, donate=(), score_dims=(t, s))


def _generate_point(cfg, serve_params, mode: str, device, fm
                    ) -> Dict[str, Any]:
    """The module-level ``generate`` loop: prefill + decode steps over a
    (1, 4) prompt, 4 new tokens, eagerly (a CUDA graph needs real
    tensors; the captured loop replays the same step)."""
    from repro_torch.serving.engine import generate
    params = fake_tree(serve_params, fm, device)
    with fm:
        prompts = torch.zeros((1, 4), dtype=torch.int32, device=device)
    kw = dict(policy=W3, max_new_tokens=4, dtype=torch.float32,
              device=device, capture=False, **_mode_kwargs(mode))
    return dict(name="generate_loop",
                fn=lambda: generate(params, prompts, cfg, **kw),
                inputs={"params": params, "prompts": prompts}, carry={},
                donate=(), score_dims=None)


def contract_points(family: str, form: str, mode: str, *, device="cuda"):
    """Every contract point of one combo, with the fake mode its tensors
    live in: the plain engine's, the spec engine's ``spec_tick`` (every
    family but ssm), ``verify`` and ``generate_loop``."""
    cfg, sp, _ = _serve_setup(family, form)
    device = trace_device(device)
    eng, fm = _engine(family, form, mode, spec=False, device=device)
    with fm:
        points = eng.contract_points()
    out = [(p, fm) for p in points]
    if family != "ssm":
        seng, sfm = _engine(family, form, mode, spec=True, device=device)
        with sfm:
            out += [(p, sfm) for p in seng.contract_points()
                    if p["name"] == "spec_tick"]
        vp = _verify_point(family, form, mode, device, fm)
        if vp:
            out.append((vp, fm))
    out.append((_generate_point(cfg, sp, mode, device, fm), fm))
    return out


def _point_checks(point: Dict[str, Any], tr, *, mode: str, family: str,
                  forbidden: set, smem_budget: int,
                  on_card: bool) -> Dict[str, List]:
    """Which passes gate this point in this mode -> their violations."""
    name = point["name"]
    checks: Dict[str, List[passes.Violation]] = {
        "no_host_callback": passes.check_no_host_callback(tr),
        "scan_carries": passes.check_scan_carries(tr),
    }
    if mode == "kernel" and on_card:
        # admit_many is a pure multi-slot scatter — no matmul, hence no
        # kernel op to demand; it must still not materialize weights
        checks["no_dequant"] = passes.check_no_dequant(
            tr, forbidden, require_kernel=name != "admit_many")
        checks["smem_budget"] = passes.check_smem_budget(tr, smem_budget)
        if point["score_dims"] and _scores_apply(family, name):
            t, s = point["score_dims"]
            checks["no_quadratic_scores"] = passes.check_no_quadratic_scores(
                tr, t, s, require_kernel=True)
    elif mode == "fallback":
        # detector sanity: the dequant path casts levels to (K, N) floats
        # and the ref attention builds (.., T, S) score tiles, so the same
        # detectors must trip here or the kernel-mode checks are vacuous
        if name in ("decode_tick", "spec_tick", "prefill_bucketed",
                    "generate_loop", "verify"):
            hit = passes.check_no_dequant(tr, forbidden,
                                          require_kernel=False)
            checks["no_dequant_signal"] = [] if hit else [passes.Violation(
                "no_dequant_signal",
                f"{name}: the dequant-fallback graph no longer trips the "
                f"dequant detector — the kernel-mode no_dequant check is "
                f"vacuous")]
        if point["score_dims"] and _scores_apply(family, name):
            t, s = point["score_dims"]
            hit = passes.check_no_quadratic_scores(tr, t, s)
            checks["no_quadratic_scores_signal"] = [] if hit else [
                passes.Violation(
                    "no_quadratic_scores_signal",
                    f"{name}: the ref-attention graph no longer trips the "
                    f"(T={t}, S={s}) score detector — the kernel-mode "
                    f"check is vacuous")]
    if point["carry"]:
        checks["carry_dtype"] = passes.check_carry_fixed_point(tr,
                                                               point=name)
    if point["donate"]:
        checks["donation"] = passes.check_donation(tr, point["donate"],
                                                   point=name)
    return checks


def lint_combo(family: str, form: str, mode: str, *,
               smem_budget: int = DEFAULT_SMEM_BUDGET,
               device="cuda") -> List[Dict]:
    """Lint every contract point of one family x serve-form x mode combo.

    Returns one record per point: ``{"point", "checks": {pass: [violation
    dicts]}, "kernels": [smem estimates], "kernel_ops": {op: count}}`` —
    empty violation lists mean the contract holds."""
    _, _, float_params = _serve_setup(family, form)
    forbidden = forbidden_dequant_shapes(float_params, W3)
    on_card = torch.device(device).type == "cuda"
    out = []
    for p, fm in contract_points(family, form, mode, device=device):
        tr = trace(p["fn"], inputs=p["inputs"], carry=p["carry"], mode=fm)
        checks = _point_checks(p, tr, mode=mode, family=family,
                               forbidden=forbidden, smem_budget=smem_budget,
                               on_card=on_card)
        rec = {"point": p["name"],
               "checks": {k: [v.to_dict() for v in vs]
                          for k, vs in checks.items()},
               "kernel_ops": kernel_op_counts(tr)}
        if mode == "kernel":
            rec["kernels"] = [
                {k: est[k] for k in ("name", "variant", "grid",
                                     "dynamic_bytes", "static_bytes",
                                     "blocks_per_sm")}
                for est in map(kernel_smem_estimate, find_kernel_ops(tr))]
        out.append(rec)
    return out


def kernel_op_counts(tr, by_variant: bool = False) -> Dict[str, int]:
    """Kernel ops of a trace by name (``qmatvec``), or by name and
    variant (``qmatvec/decode``)."""
    counts: Dict[str, int] = {}
    for rec in find_kernel_ops(tr):
        key = rec.kernel["kernel"]
        if by_variant and rec.kernel["variant"]:
            key = f"{key}/{rec.kernel['variant']}"
        counts[key] = counts.get(key, 0) + 1
    return counts


def run_sweep(families: Sequence[str] = FAMILIES,
              forms: Sequence[str] = FORMS,
              modes: Sequence[str] = MODES, *,
              smem_budget: int = DEFAULT_SMEM_BUDGET, device="cuda",
              progress=None) -> Dict[str, Any]:
    """The full contract sweep -> the JSON report the gate reads."""
    combos, n_checks, n_viol = [], 0, 0
    for family in families:
        for form in forms:
            for mode in modes:
                if progress:
                    progress(f"{family}/{form}/{mode}")
                recs = lint_combo(family, form, mode,
                                  smem_budget=smem_budget, device=device)
                nv = sum(len(v) for r in recs for v in r["checks"].values())
                n_checks += sum(len(r["checks"]) for r in recs)
                n_viol += nv
                combos.append({"family": family, "form": form, "mode": mode,
                               "violations": nv, "points": recs})
    return {"smem_budget": smem_budget, "device": str(device),
            "checks": n_checks, "violations": n_viol, "combos": combos}


def capture_report(engine, budgets: Optional[Dict[str, int]] = None
                   ) -> Dict[str, Any]:
    """Capture-count report from the engine's CUDA graphs, in the same
    shape as the contract checks: ``{"counts", "budgets", "violations"}``.
    A healthy engine captures its tick ONCE per run and each admission
    bucket once. ``budgets``: ``{"tick": n, "admit": n}``, the admit
    budget holding for every bucket."""
    caps = engine.captures
    counts = {"tick": caps["tick"]}
    counts.update({f"admit[{b}]": n for b, n in caps["admit"].items()})
    if "probe" in caps:
        counts["probe"] = caps["probe"]
    budgets = dict(budgets or {})
    viols = []
    for name, n in sorted(counts.items()):
        limit = budgets.get(name.split("[")[0])
        if limit is not None and n > limit:
            viols.append(passes.Violation(
                "capture_budget",
                f"graph '{name}' captured {n} times, budget {limit} — a "
                f"shape or a graph input is changing between calls"
            ).to_dict())
    return {"counts": counts, "budgets": budgets, "violations": viols}
