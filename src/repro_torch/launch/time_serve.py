"""Engine tok/s of ``chip_smoke.py``'s engine phase, served several times
on one warmed, captured engine, in both K/V forms: the spread a parent and
a change are compared within.

    PYTHONPATH=src python -m repro_torch.launch.time_serve [--serves N]
        [--kv bf16,int8] [--form qp|q]

Builds the full-width W3A8 qwen2-1.5b from seed 0 (``serve.build_params``)
in the ``--form`` export (``qp``: packed containers, the engine phase;
``q``: int8 levels, chip_smoke.py's q engine), and for each K/V form a
captured
``ServingEngine(slots=8, max_len=512)`` in bf16. The engine is warmed as
``chip_smoke.py`` warms it (the 16 prompts of ``profile_engine.prompts``,
10 new tokens each), then serves the same prompts ``MAX_NEW`` (32) new
tokens each ``--serves`` times; each serve is timed from its first submit
to the end of ``run_all`` with the card synchronized, as the engine
phase times its one serve. Prints one JSON line with the card as
``nvidia-smi`` names it, the tree that was imported and each serve's
tok/s.

To compare two trees in one call, run this file by its path with
``PYTHONPATH`` pointing at each tree's ``src`` in turn (parent, change,
change, parent): it imports only the engine, ``launch.serve`` and
``launch.profile_engine``, which both trees have.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

import repro_torch
from repro_torch.launch.profile_engine import MAX_NEW, card_line, prompts
from repro_torch.launch.serve import build_params, config_for
from repro_torch.serving.engine import ServingEngine

WARM_NEW = 10          # chip_smoke.py's warm-up serve: 2 * (spec_k 4 + 1)


def _serve(eng, reqs, max_new):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in reqs:
        eng.submit(p, max_new=max_new)
    done = eng.run_all()
    torch.cuda.synchronize()
    return sum(len(r.out) for r in done), time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--serves", type=int, default=5)
    ap.add_argument("--kv", default="bf16,int8",
                    help="comma-separated K/V forms: bf16, int8")
    ap.add_argument("--form", default="qp", choices=["qp", "q"],
                    help="the W3A8 export served: qp or q")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_serve needs a CUDA card")
    dev = torch.device("cuda")
    cfg = config_for("qwen2-1.5b")
    params, policy, _, _ = build_params(cfg, quant="w3", form=args.form,
                                        seed=0, device=dev)
    reqs = prompts(cfg.vocab_size)
    out = {"card": card_line(), "tree": repro_torch.__file__,
           "form": args.form}
    for kv in args.kv.split(","):
        eng = ServingEngine(params, cfg, policy=policy, slots=8, max_len=512,
                            dtype=torch.bfloat16,
                            kv_bits={"bf16": None, "int8": 8}[kv],
                            device=dev)
        _serve(eng, reqs, WARM_NEW)
        runs = [_serve(eng, reqs, MAX_NEW) for _ in range(args.serves)]
        out[kv] = {"tok_per_s": [n / s for n, s in runs],
                   "tokens": runs[0][0]}
        del eng
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
