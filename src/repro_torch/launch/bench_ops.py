"""Host cost of the registered kernel ops (``kernels/_ops.py``) on the card.

Each kernel's launch is the CUDA implementation of a registered torch op,
so a call goes wrapper -> dispatcher -> implementation. This times, on
the host, a call through the op (the public wrapper, as the serving path
makes it) against the same wrapper calling its CUDA implementation
directly (the wrapper's checks in both; the dispatcher in one), in turns
(op, direct, direct, op), at the decode tick's shapes of
qwen2-1.5b: qmatvec (M = 8, K = 1536, N = 8960, bf16) and attn_decode
(B = 8, S = 512, KV = 2, G = 6, D = 128, bf16). Each timing is the median
over rounds of ``--calls`` back-to-back launches (a synchronize ends each
round, outside the timed span; the queue never fills at these counts).

    PYTHONPATH=src python -m repro_torch.launch.bench_ops [--calls 200]

Prints one JSON line: the card, and for each kernel the op's and the
direct call's host microseconds a call and their difference.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from repro_torch.kernels import _ops
from repro_torch.kernels.attn_decode import kernel as dec_k
from repro_torch.kernels.qmatvec import kernel as qmv_k

_IMPL = {"qmatvec": qmv_k._launch, "attn_decode": dec_k._launch}


def _direct(fn):
    """``fn`` with ``_ops.op`` handing the wrappers their CUDA
    implementation itself, past the dispatcher."""
    def run():
        op = _ops.op
        _ops.op = _IMPL.__getitem__
        try:
            return fn()
        finally:
            _ops.op = op
    return run


def _per_call_us(fn, calls: int, rounds: int) -> float:
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=25)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_ops times launches on a CUDA card; none is "
                         "available")
    from repro_torch.launch.profile_engine import card_line
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((8, 1536), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randint(-2 ** 31, 2 ** 31 - 1, (154, 8960), generator=g,
                      device=dev, dtype=torch.int32)
    d = torch.rand((8960,), generator=g, device=dev)
    q = torch.randn((8, 2, 6, 128), generator=g, device=dev).to(
        torch.bfloat16)
    kc = torch.randn((8, 512, 2, 128), generator=g, device=dev).to(
        torch.bfloat16)
    lens = torch.full((8,), 400, dtype=torch.int32, device=dev)
    cases = {"qmatvec": lambda: qmv_k.qmatvec_cuda(x, w, d),
             "attn_decode": lambda: dec_k.attn_decode_cuda(q, kc, kc, lens)}
    out = {"card": card_line(), "calls": args.calls, "rounds": args.rounds}
    with torch.no_grad():
        for name, via_op in cases.items():
            direct = _direct(via_op)
            via_op(), direct()                   # build, load, warm
            runs = {"op": [], "direct": []}
            for kind in ("op", "direct", "direct", "op"):
                fn = via_op if kind == "op" else direct
                runs[kind].append(_per_call_us(fn, args.calls, args.rounds))
            op_us, direct_us = (statistics.mean(runs[k])
                                for k in ("op", "direct"))
            out[name] = {"op_us": op_us, "direct_us": direct_us,
                         "dispatch_us": op_us - direct_us,
                         "runs": runs}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
