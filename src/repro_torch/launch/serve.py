"""Serving launcher: quantize-and-serve through the batched engine on the
card (one decode call per tick, all slots at once).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --requests 8 --slots 4 --max-new 16

``--reduced`` shrinks the model for a rehearsal; ``--device cpu`` runs the
kernels' plain versions on the CPU. The same flags as the reference's
``launch/serve.py`` for what the port supports (no speculative decoding,
overload or durability flags yet).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import quant_dense
from repro_torch.core.precision import FLOAT, W3A8
from repro_torch.models import get_model
from repro_torch.serving.engine import ServingEngine


def build_params(cfg, *, quant: str, form: str, seed: int, device):
    """Float master weights from a seeded generator on ``device``, exported
    to the serve form there; the master is freed. Returns (params,
    policy)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = get_model(cfg).init(gen, cfg, device=device)
    if quant != "w3":
        return params, FLOAT
    export = {"q": quant_dense.export_levels,
              "qp": quant_dense.export_container}.get(form)
    if export:
        params = export(params, W3A8)
    return params, W3A8


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--quant", default="w3", choices=["float", "w3"])
    ap.add_argument("--form", default="qp", choices=["w", "q", "qp"],
                    help="weight form for --quant w3: levels (q) or packed "
                         "containers (qp, the paper's BRAM image)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--matmul-mode", default="auto",
                    choices=["auto", "kernel", "dequant"],
                    help="quantized-matmul dispatch: CUDA kernels, their "
                         "plain versions, or auto (kernels on CUDA)")
    ap.add_argument("--attn-mode", default="auto",
                    choices=["auto", "kernel", "ref"],
                    help="attention dispatch for prefill and decode: CUDA "
                         "kernels, reference, or auto (kernels on CUDA)")
    ap.add_argument("--kv8", action="store_true",
                    help="serve from an int8 KV cache (per-token scales)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params, policy = build_params(cfg, quant=args.quant, form=args.form,
                                  seed=args.seed, device=args.device)
    eng = ServingEngine(params, cfg, policy=policy, slots=args.slots,
                        max_len=64 + args.max_new,
                        temperature=args.temperature, eos_id=args.eos_id,
                        matmul_mode=args.matmul_mode,
                        attn_mode=args.attn_mode,
                        kv_bits=8 if args.kv8 else None, seed=args.seed,
                        device=args.device)
    # mixed prompt lengths: exercises the length-bucketed batched admission
    lens = [4, 8, 5, 12, 3, 16, 7, 9]
    t0 = time.time()
    for i in range(args.requests):
        plen = lens[i % len(lens)]
        eng.submit([(1 + i + j) % 50 + 1 for j in range(plen)],
                   max_new=args.max_new)
    done = eng.run_all()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.time() - t0
    toks = sum(len(r.out) for r in done)
    print(f"{len(done)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks / dt:.1f} tok/s on {eng.device}), "
          f"{eng.decode_calls} batched decode ticks "
          f"({toks / max(eng.decode_calls, 1):.2f} tok/tick), "
          f"{eng.prefill_calls} bucketed prefill calls "
          f"({len(done) / max(eng.prefill_calls, 1):.2f} req/prefill)")


if __name__ == "__main__":
    main()
