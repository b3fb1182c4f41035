"""Times ``qmatvec``, ``attn_decode`` and the untied 8-bit head's
``qmatmul`` at the serving path's shapes, through their public wrappers, on
the card.

    PYTHONPATH=src python -m repro_torch.launch.bench_kernels [--tag T]
        [--groups qwen,dense,head]

Groups: ``qwen`` (the default) qwen2-1.5b's projections and decode
attention and the paper MLP's layers; ``dense`` qmatvec at the decode
projections of stablelm-3b, qwen2.5-14b and qwen3-32b (M = 8); ``head``
their untied heads (M = 8) in both of qmatmul's layouts for a (K, N)
head: row-major (``n_lanes``) and stored K-contiguous (a ``.T`` view,
``k_lanes``), beside ``matmul`` on the dequantized bf16 head.

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
from repro_torch.kernels.qmatmul import kernel as qmm_k
from repro_torch.kernels.qmatmul import ops as qmm_ops
from repro_torch.kernels.qmatmul.ref import qmatmul_ref
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
# the decode projections (K, N) of stablelm-3b, qwen2.5-14b and qwen3-32b:
# q/k/v/o, up/gate, down (K = 6912, 13824 are not multiples of 80)
DENSE_PROJ = ((2560, 2560), (2560, 6912), (6912, 2560),
              (5120, 5120), (5120, 1024), (5120, 13824), (13824, 5120),
              (5120, 8192), (8192, 5120), (5120, 25600), (25600, 5120))
# their untied heads: (K = d_model, N = vocab)
HEAD_CASES = ((2560, 50304), (5120, 152064), (5120, 151936))


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
    xb = x.element_size()
    nbytes = m * k * xb + w.numel() * 4 + 2 * n * 4 + m * n * xb
    return {"kernel": "qmatvec", "shape": f"M={m} K={k} N={n}",
            "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
            "bound_ms": nbytes / 3.35e9,
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


def head_case(g, m, k, n, layout):
    """The untied 8-bit head (K, N) at M slots: int8 levels, per-channel
    delta, bf16 x. ``layout`` n_lanes: row-major levels; k_lanes: the same
    levels stored K-contiguous, as the container export stores them."""
    dev = torch.device("cuda")
    lv = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                       dtype=torch.int8)
    w = lv if layout == "n_lanes" else lv.T.contiguous().T
    del lv
    delta = torch.rand(n, generator=g, device=dev) * 0.01
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    if qmm_k.plan(m, k, n, *w.stride(), x.dtype).layout != layout:
        raise SystemExit(f"bench_kernels: head {k}x{n} did not plan {layout}")
    wdq = (w.float() * delta).to(torch.bfloat16).contiguous()
    run = lambda: qmm_ops.qmatmul(x, w, delta)
    lib = lambda: torch.matmul(x, wdq)
    err = _err(run(), qmatmul_ref(x, w, delta), torch.bfloat16,
               f"qmatmul head {k}x{n} {layout}")
    return {"kernel": "qmatmul", "variant": layout,
            "shape": f"M={m} K={k} N={n} (untied head)",
            "dtype": "bfloat16", "max_abs_err": err,
            "bound_ms": (m * k * 2 + k * n + n * 4 + m * n * 2) / 3.35e9,
            "ms": _event_ms(run), "device_ms": _device_ms(run),
            "library": "matmul on the dequantized bf16 head",
            "library_ms": _event_ms(lib), "library_device_ms": _device_ms(lib)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="", help="a label printed on each line")
    ap.add_argument("--groups", default="qwen",
                    help="comma-separated: qwen, dense, head")
    args = ap.parse_args(argv)
    groups = set(args.groups.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1234)
    cases = []
    if "qwen" in groups:
        cases += [lambda c=c: qmatvec_case(g, *c) for c in QMATVEC_CASES]
        cases += [lambda c=c: decode_case(g, *c) for c in DECODE_CASES]
    if "dense" in groups:
        cases += [lambda c=c: qmatvec_case(g, 8, *c, torch.bfloat16)
                  for c in DENSE_PROJ]
    if "head" in groups:
        cases += [lambda c=c, lay=lay: head_case(g, 8, *c, lay)
                  for c in HEAD_CASES for lay in ("n_lanes", "k_lanes")]
    for case in cases:
        print(json.dumps({"tag": args.tag, **case()}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
