"""Where the serving time goes: full-width W3A8 ``qp`` qwen2-1.5b served by
the engine on the card, under ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_engine [--kv8]
        [--steady-only]

Serves the same 16 requests as ``chip_smoke.py`` (the launch/serve.py
prompt mix plus eight 100-250-token prompts, 32 new tokens each, 8 slots,
max_len 512, bf16) once to warm up, then again under the profiler, and
then times steady-state decode ticks with all 8 slots active
(``--steady-only``: the warm-up and the ticks only). Prints one
JSON line: wall time and tokens of the profiled run, device time summed by
kernel (the port's four CUDA kernels by name, everything else as
``other``; ``qmatvec``'s split by variant, ``decode`` and ``prefill``, from
the names of its CUDA kernels), the device's idle share of the wall time,
ms per steady decode tick, and the device ms of one steady tick by kernel
(``STEADY_TICKS`` ticks under the profiler, every slot active: all of its
``qmatvec`` launches are decode launches). Device times are the self
times of the profiler's CUDA-type rows (kernels, copies, sets): an operator's row also carries
the time of the kernels it launched, so summing every row would count
those twice. The idle share is 1 - (summed kernel time / wall time),
exact for one stream.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import build_params
from repro_torch.serving.engine import ServingEngine

# launch/serve.py's prompt mix, then 100-250-token prompts that reach the
# 128 and 256 buckets; chip_smoke.py serves the same requests
PROMPT_LENS = [4, 8, 5, 12, 3, 16, 7, 9, 100, 130, 180, 250, 120, 200, 140, 230]
MAX_NEW = 32
STEADY_TICKS = 20
KERNELS = ("qmatvec", "qmatmul", "attn_decode", "attn_prefill")
QMATVEC_VARIANTS = ("decode", "prefill")


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
    """(name, self device ms) of the profiler's CUDA-type rows."""
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us:
            yield ev.key, us / 1e3


def qmatvec_ms_by_variant(prof):
    """Self device ms of ``qmatvec``'s CUDA kernels by variant: a kernel
    whose name holds ``qmatvec_kernel_<variant>`` counts under it."""
    out = dict.fromkeys(QMATVEC_VARIANTS, 0.0)
    for key, ms in _cuda_rows(prof):
        for v in QMATVEC_VARIANTS:
            if f"qmatvec_kernel_{v}" in key:
                out[v] += ms
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kv8", action="store_true")
    ap.add_argument("--steady-only", action="store_true",
                    help="skip the profiled run of the 16 requests; time "
                         "only the steady ticks (quick A/B of two trees)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_engine needs a CUDA card")
    dev = torch.device("cuda")
    cfg = get_config("qwen2-1.5b")
    params, policy = build_params(cfg, quant="w3", form="qp", seed=0,
                                  device=dev)
    kw = dict(policy=policy, slots=8, max_len=512, dtype=torch.bfloat16,
              kv_bits=8 if args.kv8 else None, device=dev)
    _serve(ServingEngine(params, cfg, **kw), cfg.vocab_size)     # warm-up
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {"card": card_line(), "kv": "int8" if args.kv8 else "bf16"}
    if not args.steady_only:
        eng = ServingEngine(params, cfg, **kw)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            toks = _serve(eng, cfg.vocab_size)
            wall = time.perf_counter() - t0
        by_kernel = device_ms_by_kernel(prof)
        busy = sum(by_kernel.values())
        out.update({
            "profiled_wall_s": wall, "tokens": toks,
            "tok_per_s": toks / wall, "decode_calls": eng.decode_calls,
            "prefill_calls": eng.prefill_calls,
            "device_ms_by_kernel": by_kernel,
            "qmatvec_device_ms_by_variant": qmatvec_ms_by_variant(prof),
            "device_busy_ms": busy, "idle_share": 1.0 - busy / (wall * 1e3)})

    # steady state: 8 long requests, then time ticks with every slot active
    eng = ServingEngine(params, cfg, **kw)
    for i in range(8):
        eng.submit([i + 1] * 64, max_new=2 * STEADY_TICKS + 8)
    eng.step(); eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEADY_TICKS):
        eng.step()
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) / STEADY_TICKS * 1e3
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(STEADY_TICKS):
            eng.step()
        torch.cuda.synchronize()
    tick_dev = {k: v / STEADY_TICKS
                for k, v in device_ms_by_kernel(prof).items()}
    out.update({"steady_tick_ms_8_slots": tick_ms,
                "steady_tok_per_s_8_slots": 8 * 1e3 / tick_ms,
                "steady_tick_device_ms_by_kernel": tick_dev})
    print(json.dumps(out))


if __name__ == "__main__":
    main()
