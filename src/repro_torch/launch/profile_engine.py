"""Where the serving time goes: a full-width W3A8 ``qp`` model (qwen2-1.5b
unless ``--arch`` names another config — dense, MoE, ssm, hybrid, audio
or vlm — ``--layers`` cutting its depth as ``launch/serve.py`` does;
``--form q`` the int8-level export instead, every projection through
qmatmul's ``n_lanes``) served by the engine on the card, under
``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_engine [--kv8]
        [--steady-only] [--spec-k K] [--eager] [--quant w3|float]
        [--form qp|q] [--fp32] [--arch A] [--layers N]

Serves the same 16 requests as ``chip_smoke.py`` (the launch/serve.py
prompt mix plus eight 100-250-token prompts, 32 new tokens each, 8 slots,
max_len 512, bf16) once to warm up, then again, on the same engine, under
the profiler, and then times steady-state decode ticks with all 8 slots
active (``--steady-only``: the warm-up and the ticks only). The engine
replays its tick and admissions as CUDA graphs, captured in the warm-up;
``--eager`` runs it with ``capture=False``, so one call can time both, in
turns, beside another tree's run of this script. Prints one
JSON line: wall time and tokens of the profiled run, device time summed by
kernel (the port's four CUDA kernels by name, everything else as
``other``; ``qmatvec``'s split by variant, ``decode`` and ``prefill``, from
the names of its CUDA kernels), the device's idle share of the wall time,
host ms per steady decode tick, and the device ms of one steady tick by
kernel and the card's idle share over those ticks
(``STEADY_TICKS`` ticks under the profiler, every slot active: all of its
``qmatvec`` launches are decode launches). Device times are the self
times of the profiler's CUDA-type rows (kernels, copies, sets): an operator's row also carries
the time of the kernels it launched, so summing every row would count
those twice. The idle share is 1 - (summed kernel time / wall time),
exact for one stream.

``--spec-k K`` profiles self-speculative serving instead: the seeded float
master, its weights cast once to bf16 (``serve.build_params``), is the
target (FLOAT policy) and
its W3A8 container export drafts K tokens a tick. ``attn_prefill``'s
device time is then split by use, the target's verify (T = K + 1) and the
admissions (T = bucket). The profiled run is driven step by step, noting
the admission rounds and the tick of each step from the engine's
``prefill_calls`` and ``decode_calls``; a step admits before it ticks, an
admission round launches ``attn_prefill`` once a layer of target and
drafter, a tick once a target layer (once a shared-block application for
hybrid: ``attn_layers``), and one stream runs the kernels in
launch order, so the i-th ``attn_prefill`` kernel of the trace (by start)
is the i-th launch of that sequence (the counts must match). A steady
tick's ``attn_prefill`` is all verify.

``--fp32`` serves the seeded fp32 master itself (FLOAT policy, fp32
activations and K/V; with ``--spec-k`` its qp export drafts), as
``chip_smoke.py``'s fp32 gates and resilience phase do: every
``attn_prefill`` then runs the fp32 kernel. Every form is built one layer
at a time on the card (``api.init_export``; with ``--spec-k`` the master
and its drafter in one pass), so the file can time another tree's ``src``
(``PYTHONPATH``) if that tree has ``init_export``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from repro_torch.core.precision import FLOAT
from repro_torch.launch.serve import (as_master, build_params, config_for,
                                     export_qp)
from repro_torch.models import api as model_api
from repro_torch.serving.engine import ServingEngine, check_family

# launch/serve.py's prompt mix, then 100-250-token prompts that reach the
# 128 and 256 buckets; chip_smoke.py serves the same requests
PROMPT_LENS = [4, 8, 5, 12, 3, 16, 7, 9, 100, 130, 180, 250, 120, 200, 140, 230]
MAX_NEW = 32
STEADY_TICKS = 20
KERNELS = ("qmatvec", "qmatmul", "attn_decode", "attn_prefill")
QMATVEC_VARIANTS = ("decode", "prefill")


def attn_layers(cfg) -> int:
    """Attention launches of one forward: one a layer for the transformer
    families, one a shared-block application for hybrid, none for ssm."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    return cfg.num_layers


def prompts(vocab: int) -> list[list[int]]:
    """The 16 prompts of the profiled run, token ids in [1, vocab)."""
    return [[(7 * i + 3 * j) % (vocab - 1) + 1 for j in range(n)]
            for i, n in enumerate(PROMPT_LENS)]


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _serve(eng, vocab):
    for p in prompts(vocab):
        eng.submit(p, max_new=MAX_NEW)
    done = eng.run_all()
    torch.cuda.synchronize()
    return sum(len(r.out) for r in done)


def device_ms_by_kernel(prof, kernels=KERNELS):
    """Self device ms of the profiler's CUDA-type rows, by port kernel name
    (anything else as ``other``). Op rows are skipped: their self device
    time repeats the kernel rows beneath them."""
    out = {k: 0.0 for k in kernels + ("other",)}
    for key, ms in _cuda_rows(prof):
        out[next((k for k in kernels if f"{k}_kernel" in key), "other")] += ms
    return out


def _cuda_rows(prof):
    """(name, device ms) of each CUDA-type event of the profiler's trace
    (kernels, copies, sets), read from its raw kineto events: what the
    CUDA-type rows of ``key_averages()`` sum, without the function events
    it parses first (seconds of host for four eager ticks of a 64-layer
    model)."""
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda and not ev.is_async() \
                and ev.duration_ns():
            yield ev.name(), ev.duration_ns() / 1e6


def qmatvec_ms_by_variant(prof):
    """Self device ms of ``qmatvec``'s CUDA kernels by variant: a kernel
    whose name holds ``qmatvec_kernel_<variant>`` counts under it."""
    out = dict.fromkeys(QMATVEC_VARIANTS, 0.0)
    for key, ms in _cuda_rows(prof):
        for v in QMATVEC_VARIANTS:
            if f"qmatvec_kernel_{v}" in key:
                out[v] += ms
    return out


def _serve_by_step(eng, vocab):
    """``_serve`` driven step by step, draining as ``run_all`` does (and
    whenever a step ran no tick). Returns the tokens served and, per step,
    (admission rounds, ticks) from the engine's call counters."""
    for p in prompts(vocab):
        eng.submit(p, max_new=MAX_NEW)
    done, steps = [], []
    while len(done) < len(PROMPT_LENS):
        r0, t0 = eng.prefill_calls, eng.decode_calls
        eng.step()
        steps.append((eng.prefill_calls - r0, eng.decode_calls - t0))
        if eng.decode_calls == t0 or eng.decode_calls % eng.drain_every == 0:
            done.extend(eng.drain())
    torch.cuda.synchronize()
    return sum(len(r.out) for r in done), steps


def launch_uses(steps, layers, draft_layers):
    """The use of every ``attn_prefill`` launch, in launch order: a step's
    admission rounds (``layers + draft_layers`` launches each) come before
    its tick (``layers`` verify launches)."""
    seq = []
    for rounds, ticks in steps:
        seq += ["admission"] * (rounds * (layers + draft_layers))
        seq += ["verify"] * (ticks * layers)
    return seq


def attn_prefill_ms_by_use(prof, uses):
    """Device ms and launches of the ``attn_prefill`` kernels by use:
    ``uses`` holds the use of every launch in order; the kernels of the
    trace, sorted by start, are those launches in that order (one
    stream). The fp32 kernel's split merge (``attn_prefill_kernel_merge``)
    belongs to the launch before it: its time is added to that launch's
    use and it is counted apart, as ``merges``."""
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "attn_prefill_kernel" in e.name),
                 key=lambda e: e.time_range.start)
    ms = []                       # [device ms, merges] of each launch
    for e in evs:
        t = (e.time_range.end - e.time_range.start) / 1e3
        if "attn_prefill_kernel_merge" in e.name:
            if not ms:
                raise RuntimeError("an attn_prefill merge before any launch")
            ms[-1][0] += t
            ms[-1][1] += 1
        else:
            ms.append([t, 0])
    if len(ms) != len(uses):
        raise RuntimeError(f"{len(ms)} attn_prefill kernels in the trace, "
                           f"{len(uses)} launches")
    out = {"verify": 0.0, "admission": 0.0}
    for (t, _), use in zip(ms, uses):
        out[use] += t
    out["verify_launches"] = uses.count("verify")
    out["admission_launches"] = uses.count("admission")
    out["merges"] = sum(n for _, n in ms)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b",
                    help="any config: dense, moe, ssm, hybrid, audio, vlm")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the first N layers (full width), as "
                         "launch/serve.py --layers")
    ap.add_argument("--kv8", action="store_true")
    ap.add_argument("--steady-only", action="store_true",
                    help="skip the profiled run of the 16 requests; time "
                         "only the steady ticks (quick A/B of two trees)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="profile speculative serving: the float target "
                         "verifies K drafts of its 3-bit export a tick")
    ap.add_argument("--eager", action="store_true",
                    help="run the engine eagerly (capture=False), not as "
                         "replayed CUDA graphs")
    ap.add_argument("--quant", choices=["w3", "float"], default=None,
                    help="the served weights: the W3A8 qp export (default "
                         "without --spec-k) or the float master cast to "
                         "bf16 (default with it)")
    ap.add_argument("--form", choices=["qp", "q"], default="qp",
                    help="the W3A8 export: packed containers (qp, qmatvec) "
                         "or int8 levels (q, qmatmul n_lanes)")
    ap.add_argument("--fp32", action="store_true",
                    help="serve the fp32 master in fp32 (FLOAT policy), "
                         "not an export or a bf16 cast")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_engine needs a CUDA card")
    dev = torch.device("cuda")
    cfg = config_for(args.arch, layers=args.layers)
    check_family(cfg, kv_bits=8 if args.kv8 else None, spec_k=args.spec_k)
    spec_k = args.spec_k
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    if args.fp32:
        quant = "float32"
        gen = torch.Generator(device=dev).manual_seed(0)
        policy, draft_cfg, draft_params = FLOAT, None, None
        if spec_k:
            params, qp = model_api.init_export(gen, cfg,
                                               (as_master, export_qp),
                                               device=dev)
            draft_cfg, draft_params = model_api.draft_of(cfg, qp)
        else:
            params = model_api.init_export(gen, cfg, as_master, device=dev)
    else:
        quant = args.quant or ("float" if spec_k else "w3")
        params, policy, draft_cfg, draft_params = build_params(
            cfg, quant=quant, form=args.form, seed=0, device=dev,
            spec_k=spec_k)
    kw = dict(policy=policy, slots=8, max_len=512, dtype=dtype,
              kv_bits=8 if args.kv8 else None, spec_k=spec_k,
              draft_params=draft_params, draft_cfg=draft_cfg,
              capture=not args.eager, device=dev)
    eng = ServingEngine(params, cfg, **kw)
    _serve(eng, cfg.vocab_size)                     # warm-up, captures
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {"card": card_line(), "kv": "int8" if args.kv8 else "bf16",
           "quant": quant, "form": args.form if quant == "w3" else None,
           "spec_k": spec_k, "captured": not args.eager}
    if not args.steady_only:
        r0, t0_ = eng.prefill_calls, eng.decode_calls
        acc0, dr0 = eng.spec_accepted, eng.spec_drafted
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            toks, steps = _serve_by_step(eng, cfg.vocab_size)
            wall = time.perf_counter() - t0
        by_kernel = device_ms_by_kernel(prof)
        busy = sum(by_kernel.values())
        out.update({
            "profiled_wall_s": wall, "tokens": toks,
            "tok_per_s": toks / wall,
            "decode_calls": eng.decode_calls - t0_,
            "prefill_calls": eng.prefill_calls - r0,
            "device_ms_by_kernel": by_kernel,
            "qmatvec_device_ms_by_variant": qmatvec_ms_by_variant(prof),
            "device_busy_ms": busy, "idle_share": 1.0 - busy / (wall * 1e3)})
        if spec_k:
            by_use = attn_prefill_ms_by_use(prof, launch_uses(
                steps, attn_layers(cfg), attn_layers(draft_cfg)))
            out.update({"attn_prefill_device_ms_by_use": by_use,
                        "spec_accept_rate": (eng.spec_accepted - acc0)
                        / (eng.spec_drafted - dr0)})

    # steady state: 8 long requests, then time ticks with every slot active
    for i in range(8):
        eng.submit([i + 1] * 64, max_new=(2 * STEADY_TICKS + 4)
                   * (spec_k + 1) + 4)
    eng.step(); eng.step()
    eng.drain()
    torch.cuda.synchronize()
    acc0 = eng.spec_accepted
    t0 = time.perf_counter()
    for _ in range(STEADY_TICKS):
        eng.step()
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) / STEADY_TICKS * 1e3
    eng.drain()
    # every slot emits its pending token plus the drafts accepted
    tok_per_tick = 8 + (eng.spec_accepted - acc0) / STEADY_TICKS
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(STEADY_TICKS):
            eng.step()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) / STEADY_TICKS * 1e3
    tick_dev = {k: v / STEADY_TICKS
                for k, v in device_ms_by_kernel(prof).items()}
    dev_ms = sum(tick_dev.values())
    out.update({"steady_tick_ms_8_slots": tick_ms,
                "steady_tokens_per_tick": tok_per_tick,
                "steady_tok_per_s_8_slots": tok_per_tick * 1e3 / tick_ms,
                "steady_tick_device_ms_by_kernel": tick_dev,
                "steady_tick_device_ms": dev_ms,
                "steady_profiled_tick_host_ms": prof_ms,
                "steady_idle_share": 1.0 - dev_ms / prof_ms,
                "captures": eng.captures})
    print(json.dumps(out))


if __name__ == "__main__":
    main()
