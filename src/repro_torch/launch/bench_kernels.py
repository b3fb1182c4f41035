"""Times ``qmatvec`` and ``attn_decode`` at the serving path's shapes, through
their public wrappers, on the card.

    PYTHONPATH=src python -m repro_torch.launch.bench_kernels [--tag T]

Uses only the wrappers (``kernels/qmatvec/ops.py::qmatvec``,
``kernels/attn_decode/ops.py::attn_decode``), their plain versions and
``core/packing.py``, so the same file times two trees of the port in one
call: run it with ``PYTHONPATH`` pointing at each tree's ``src`` in turn
(parent, change, change, parent). Each case is held against its plain
version first (1e-4 x max|ref| in fp32, 2e-2 x max|ref| in bf16). Prints one
JSON line per case: the median CUDA-event ms of one call, the profiler's
device ms of one call (every kernel it launched), the library call's device
ms (``addmm`` on the dequantized W; SDPA over the cache with its KV heads
expanded) and the max abs error.
"""
from __future__ import annotations

import argparse
import json
import statistics

import torch
import torch.nn.functional as F

from repro_torch.core.packing import pack_matrix, unpack_matrix
from repro_torch.kernels.attn_decode import ops as dec_ops
from repro_torch.kernels.attn_decode.ref import attn_decode_ref
from repro_torch.kernels.qmatvec import ops as qmv_ops
from repro_torch.kernels.qmatvec.ref import qmatvec_ref

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
REPS = 50                      # calls a timing takes the median / mean of
# qwen2-1.5b's four projection shapes (K, N), then the paper MLP's
QWEN = ((1536, 1536), (1536, 256), (1536, 8960), (8960, 1536))
QMATVEC_CASES = ([(8, k, n, torch.bfloat16) for k, n in QWEN]
                 + [(m, k, n, torch.bfloat16) for m in (512, 2048)
                    for k, n in QWEN[2:]]
                 + [(100, k, 1022, torch.float32) for k in (784, 429)])
# (B, S, cache): the engine's 8 slots at max_len 512, then B = 16, S = 2048
DECODE_CASES = [(8, 512, "bf16"), (8, 512, "int8"), (16, 512, "bf16"),
                (8, 2048, "bf16")]


def _event_ms(fn):
    fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(REPS):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def _device_ms(fn):
    """Device ms of one call: the self time of every CUDA-type profiler row
    over ``REPS`` calls, divided by ``REPS``."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", 0.0)
             for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / REPS


def _err(got, ref, dtype, what):
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    if not bool(got.isfinite().all()) or err > TOL[dtype] * float(
            ref.abs().max()):
        raise SystemExit(f"bench_kernels: {what}: max abs err {err}")
    return err


def qmatvec_case(g, m, k, n, dtype):
    dev = torch.device("cuda")
    w = pack_matrix(torch.randint(-4, 4, (k, n), generator=g, device=dev,
                                  dtype=torch.int8), 3)
    delta = torch.rand(n, generator=g, device=dev) * 0.05
    bias = torch.randn(n, generator=g, device=dev)
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    wdq = (unpack_matrix(w, k, 3).float() * delta).to(dtype)
    bx = bias.to(dtype)
    run = lambda: qmv_ops.qmatvec(x, w, delta, k=k, bias=bias)
    lib = lambda: torch.addmm(bx, x, wdq)
    err = _err(run(), qmatvec_ref(x, w, delta, k, bias=bias), dtype,
               f"qmatvec {m}x{k}x{n}")
    return {"kernel": "qmatvec", "shape": f"M={m} K={k} N={n}",
            "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
            "ms": _event_ms(run), "device_ms": _device_ms(run),
            "library": "addmm", "library_device_ms": _device_ms(lib)}


def decode_case(g, b, s, cache):
    dev = torch.device("cuda")
    kvh, grp, hd = 2, 6, 128
    lens = torch.linspace(0, s, b, device=dev).round().to(torch.int32)
    q = torch.randn((b, 1, kvh * grp, hd), generator=g,
                    device=dev).to(torch.bfloat16)
    if cache == "int8":
        kc, vc = (torch.randint(-127, 128, (b, s, kvh, hd), generator=g,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand((b, s), generator=g, device=dev) * 0.02
                  for _ in range(2))
        kl = (kc.float() * ks[..., None, None]).to(torch.bfloat16)
        vl = (vc.float() * vs[..., None, None]).to(torch.bfloat16)
    else:
        kc, vc = (torch.randn((b, s, kvh, hd), generator=g,
                              device=dev).to(torch.bfloat16)
                  for _ in range(2))
        ks = vs = None
        kl, vl = kc, vc
    kh = kl.transpose(1, 2).repeat_interleave(grp, dim=1)
    vh = vl.transpose(1, 2).repeat_interleave(grp, dim=1)
    qs = q.transpose(1, 2)
    mask = (torch.arange(s, device=dev)[None, :]
            < lens[:, None])[:, None, None, :]
    run = lambda: dec_ops.attn_decode(q, kc, vc, lens, ks, vs)
    lib = lambda: F.scaled_dot_product_attention(
        qs, kh, vh, attn_mask=mask)
    err = _err(run(), attn_decode_ref(q, kc, vc, lens, ks, vs),
               torch.bfloat16, f"attn_decode B={b} S={s} {cache}")
    return {"kernel": "attn_decode",
            "shape": f"B={b} S={s} KV={kvh} G={grp} D={hd} lens 0..S",
            "dtype": f"bfloat16/kv-{cache}", "max_abs_err": err,
            "ms": _event_ms(run), "device_ms": _device_ms(run),
            "library": "SDPA", "library_device_ms": _device_ms(lib)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="", help="a label printed on each line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1234)
    for m, k, n, dt in QMATVEC_CASES:
        print(json.dumps({"tag": args.tag,
                          **qmatvec_case(g, m, k, n, dt)}),
              flush=True)
    for b, s, cache in DECODE_CASES:
        print(json.dumps({"tag": args.tag,
                          **decode_case(g, b, s, cache)}),
              flush=True)


if __name__ == "__main__":
    main()
