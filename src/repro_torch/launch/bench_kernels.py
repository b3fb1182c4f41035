"""Times ``qmatvec``, ``attn_decode``, ``qmatmul`` (the untied 8-bit head,
the ``q`` form's projections) and the fp32 ``attn_prefill`` at the serving
path's shapes, through their public wrappers, on the card.

    PYTHONPATH=src python -m repro_torch.launch.bench_kernels [--tag T]
        [--groups qwen,dense,head,q,prefill32,moe,fp32sum,router,decode_g,lse]

Groups: ``qwen`` (the default) qwen2-1.5b's projections and decode
attention and the paper MLP's layers; ``dense`` qmatvec at the decode
projections of stablelm-3b, qwen2.5-14b and qwen3-32b (M = 8); ``head``
their untied heads (M = 8) in both of qmatmul's layouts for a (K, N)
head: row-major (``n_lanes``) and stored K-contiguous (a ``.T`` view,
``k_lanes``), beside ``matmul`` on the dequantized bf16 head; ``q``
qwen2-1.5b's projections in the ``q`` form (row-major int8 levels,
``n_lanes``) at decode (M = 8) and prefill M (512, 2048), bf16 and fp32
x, with the QKV bias where qwen2 has it, beside ``addmm`` on the
dequantized matrix in x's dtype (TF32 off), and the plain version;
``prefill32`` the fp32 ``attn_prefill`` (fp32 and int8 K/V) at the
largest bucket (T = S = 256) of qwen2-1.5b and stablelm-3b and at the
speculative verify shape (T = 5, S = 512), beside SDPA over the
(dequantized) K/V in fp32, and the plain version; ``moe`` the MoE
family's shapes in bf16: phi3.5-moe's and mixtral-8x22b's expert products
(row-major int8 levels, ``n_lanes``) at the capacity M of a decode tick
(1, 2), of an admission (80 = a 64-token bucket x 8 rows; 10240 = the
4096 bucket) and of mixtral's 4500-token solo prefill (1406), beside
``addmm`` on the dequantized bf16 expert; their routers (row-major
(d, E) levels, ``k_lanes``, fp32 out) at M = 8 and at the 4096 bucket's
32768 rows, beside ``addmm`` on the dequantized bf16 router; mixtral's
windowed attn_prefill (B = 1, T = S = 4500, KV = 8, G = 6, D = 128,
lo = max(t - 4095, 0)) beside SDPA with the window mask; and attn_decode
over a full 4096-slot ring (B = 8), beside SDPA; ``fp32sum`` the
precision of fp32 x through the tensor cores (qmatvec, qmatmul's n_lanes
and K-major k_lanes) at the shapes of mixtral's path check, and of bf16 x
at mixtral's longest K (16384, the expert down projection; fp32 and bf16
output, so the sum's error shows apart from the output's rounding),
against a float64 product, beside the plain version's; ``router`` the
row-major k_lanes kernel (the MoE routers at M = 8, 16, 512 and 32768,
the digit and phoneme heads) in bf16 and fp32 x beside ``addmm`` on the
dequantized W in x's dtype; ``decode_g`` attn_decode at G = 1 (D = 80
and 64, bf16 / int8 / fp32), G = 4 (KV = 8, D = 128) and G = 6, beside
SDPA, with the plan's KV heads a block; ``lse`` attn_prefill at the
verify shape and the 256 bucket (bf16, int8 and fp32 K/V, both kernels)
without and, where the tree's wrapper takes it, with ``with_lse``. Lines
carry a hash of the kernel's output (``out_sha``), so two trees' runs
compare bit for bit.

Uses only the wrappers (``kernels/*/ops.py``), their plain versions and
``core/packing.py``, so the same file times two trees of the port in one
call: run it with ``PYTHONPATH`` pointing at each tree's ``src`` in turn
(parent, change, change, parent). Each case is held against its plain
version first (1e-4 x max|ref| in fp32, 2e-2 x max|ref| in bf16). Prints one
JSON line per case: the median CUDA-event ms of one call, the profiler's
device ms of one call (every kernel it launched), the library call's device
ms (``addmm`` on the dequantized W; SDPA over the cache with its KV heads
expanded), the bound (the larger of bytes at 3.35 TB/s and operations:
qmatvec's and qmatmul's products at the 989 TFLOP/s bf16 tensor-core peak,
three times over for fp32 x, which they split into three bf16 planes; the
fp32 attn_prefill's at the 67 TFLOP/s of fp32 on the CUDA cores) and the
max abs error; the ``q`` and ``prefill32`` cases also the plain version's
and the library call's CUDA-event ms, and the launch counters' variant.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics

import torch
import torch.nn.functional as F

from repro_torch.core.packing import pack_matrix, unpack_matrix
from repro_torch.kernels.attn_decode import kernel as dec_k
from repro_torch.kernels.attn_decode import ops as dec_ops
from repro_torch.kernels.attn_decode.ref import attn_decode_ref, scale_q
from repro_torch.kernels.attn_prefill import kernel as pf_k
from repro_torch.kernels.attn_prefill import ops as pf_ops
from repro_torch.kernels.attn_prefill.ref import attn_prefill_ref
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
# the q form's projections (K, N, QKV bias) at decode and prefill M, in
# bf16 x (the q engine) and fp32 x (the fp32 path check)
Q_CASES = [(m, k, n, bias, dtype) for dtype in (torch.bfloat16, torch.float32)
           for m in (8, 512, 2048)
           for k, n, bias in ((1536, 1536, True), (1536, 256, True),
                              (1536, 8960, False), (8960, 1536, False))]
# fp32 attn_prefill: (B, T, S, KV, G, D, K/V): qwen2-1.5b's and
# stablelm-3b's largest bucket, and the speculative verify shape
PREFILL32_CASES = [(8, 256, 256, 2, 6, 128), (8, 256, 256, 32, 1, 80),
                   (8, 5, 512, 2, 6, 128)]
# attn_prefill with and without its log-sum-exp: (B, T, S, KV, G, D), the
# verify shape and qwen2-1.5b's largest bucket, in every K/V form
LSE_CASES = [(c, kv, dt) for c in ((8, 5, 512, 2, 6, 128),
                                   (8, 256, 256, 2, 6, 128))
             for kv, dt in (("bf16", torch.bfloat16),
                            ("int8", torch.bfloat16),
                            ("fp32", torch.float32))]
# the MoE family: expert products (M, K, N) at the capacity M of a decode
# tick, an admission and mixtral's solo prefill; routers (M, K, N = E)
MOE_EXPERT_CASES = ([(m, k, n) for m in (1, 80)
                     for k, n in ((4096, 6400), (6400, 4096))]
                    + [(m, k, n) for m in (2, 1406, 10240)
                       for k, n in ((6144, 16384), (16384, 6144))])
MOE_ROUTER_CASES = ((8, 4096, 16), (8, 6144, 8), (32768, 6144, 8))
# row-major k_lanes (the routers and the MLP heads), bf16 and fp32 x: the
# routers at a tick (M = 8, 16), an admission round (8 x 64 tokens) and
# mixtral's 4096 bucket; the digit (N = 10) and phoneme (N = 61) heads
ROUTER_CASES = [(m, k, n, dt, what) for dt in (torch.bfloat16, torch.float32)
                for m, k, n, what in (
                    (8, 4096, 16, "MoE router"), (8, 6144, 8, "MoE router"),
                    (16, 4096, 16, "MoE router"),
                    (512, 4096, 16, "MoE router"),
                    (32768, 6144, 8, "MoE router"),
                    (100, 1022, 10, "digit head"),
                    (128, 1022, 61, "phoneme head"))]
# attn_decode by query heads a KV head: G = 1 (stablelm-3b's D = 80,
# zamba2-1.2b's and musicgen-large's D = 64), G = 4 (phi3.5-moe), G = 6
# (qwen2-1.5b): (B, S, cache, KV, G, D, q dtype)
DECODE_G_CASES = ([(8, 512, c, 32, 1, d, torch.bfloat16)
                   for d in (80, 64) for c in ("bf16", "int8")]
                  + [(8, 512, "fp32", 32, 1, d, torch.float32)
                     for d in (80, 64)]
                  + [(8, 512, c, 8, 4, 128, torch.bfloat16)
                     for c in ("bf16", "int8")]
                  + [(8, 512, c, 2, 6, 128, torch.bfloat16)
                     for c in ("bf16", "int8")])
MOE_WINDOW = (4500, 4096)            # mixtral's solo prompt and its window
# fp32 x through the tensor cores at the MoE path check's shapes: mixtral's
# attention projections over 2 x 4608 tokens and at a decode tick (M = 2),
# its expert products at that prefill's capacity M (2880) and a tick's, and
# its untied head read K-major
FP32SUM_CASES = [("qmatvec", 9216, 6144, 6144), ("qmatvec", 9216, 6144, 1024),
                 ("qmatvec", 2, 6144, 6144),
                 ("n_lanes", 2880, 6144, 16384), ("n_lanes", 2880, 16384, 6144),
                 ("n_lanes", 2, 6144, 16384), ("n_lanes", 2, 16384, 6144),
                 ("k_lanes", 8, 6144, 32768)]
FP32SUM_CASES = [c + (torch.float32,) for c in FP32SUM_CASES]
# bf16 x at mixtral's K = 16384: qmatvec and n_lanes at decode and prefill
# M, and a K-major k_lanes table
FP32SUM_CASES += [("qmatvec", 8, 16384, 6144, torch.bfloat16),
                  ("qmatvec", 2880, 16384, 6144, torch.bfloat16),
                  ("n_lanes", 2, 16384, 6144, torch.bfloat16),
                  ("n_lanes", 2880, 16384, 6144, torch.bfloat16),
                  ("k_lanes", 8, 16384, 32768, torch.bfloat16)]


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


def _digest(t) -> str:
    """The output's bytes, hashed: two trees' runs of the same case (the
    same file, the same seeds) compare bit for bit by it."""
    return hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu()
                          .numpy().tobytes()).hexdigest()[:16]


def _planes(dtype):
    """bf16 planes a tensor-core kernel splits x into (qmatvec, qmatmul):
    fp32 x runs as three, each product at the bf16 tensor-core peak."""
    return 3 if dtype == torch.float32 else 1


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
            "bound_ms": max(nbytes / 3.35e9, _planes(dtype) * 2 * m * k * n
                            / 989e9),
            "ms": _event_ms(run), "device_ms": _device_ms(run),
            "library": "addmm", "library_device_ms": _device_ms(lib)}


def decode_case(g, b, s, cache, kvh=2, grp=6, hd=128, dtype=torch.bfloat16):
    dev = torch.device("cuda")
    lens = torch.linspace(0, s, b, device=dev).round().to(torch.int32)
    q = torch.randn((b, 1, kvh * grp, hd), generator=g,
                    device=dev).to(dtype)
    if cache == "int8":
        kc, vc = (torch.randint(-127, 128, (b, s, kvh, hd), generator=g,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand((b, s), generator=g, device=dev) * 0.02
                  for _ in range(2))
        kl = (kc.float() * ks[..., None, None]).to(dtype)
        vl = (vc.float() * vs[..., None, None]).to(dtype)
    else:
        kc, vc = (torch.randn((b, s, kvh, hd), generator=g,
                              device=dev).to(dtype)
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
    out = run()
    err = _err(out, attn_decode_ref(q, kc, vc, lens, ks, vs),
               dtype, f"attn_decode B={b} S={s} G={grp} D={hd} {cache}")
    tot = int(lens.sum())
    nbytes = (2 * b * kvh * grp * hd * q.element_size()
              + 2 * tot * kvh * hd * kc.element_size()
              + (2 * tot * 4 if ks is not None else 0) + b * 4)
    return {"kernel": "attn_decode",
            "shape": f"B={b} S={s} KV={kvh} G={grp} D={hd} lens 0..S",
            "dtype": f"{str(dtype).removeprefix('torch.')}/kv-{cache}",
            "hb": getattr(dec_k.plan(b, s, kvh, grp, hd, kc.dtype), "hb", 1),
            "out_sha": _digest(out),
            "max_abs_err": err, "bound_ms": nbytes / 3.35e9,
            "ms": _event_ms(run), "device_ms": _device_ms(run),
            "library": "SDPA", "library_ms": _event_ms(lib),
            "library_device_ms": _device_ms(lib)}


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


def _counted(fn, mod, attr):
    """Run ``fn`` once and return the keys of ``mod.<attr>`` (a launch
    counter by variant) that it moved; [] where the tree has no such
    counter."""
    split = getattr(mod, attr, None)
    if split is None:
        return []
    before = dict(split)
    fn()
    return [k for k in split if split[k] != before[k]]


def _merges(fn):
    """The fp32 attn_prefill's split merges one call of ``fn`` launched;
    None where the tree does not count them."""
    before = getattr(pf_k, "merges", None)
    if before is None:
        return None
    fn()
    return pf_k.merges - before


def q_case(g, m, k, n, bias, dtype):
    """The q form's projection: (K, N) row-major int8 levels, per-channel
    delta, optional bias, x in ``dtype``."""
    dev = torch.device("cuda")
    w = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                      dtype=torch.int8)
    delta = torch.rand(n, generator=g, device=dev) * 0.01
    b = torch.randn(n, generator=g, device=dev) if bias else None
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    wdq = (w.float() * delta).to(dtype)
    bx = (b if bias else torch.zeros(n, device=dev)).to(dtype)
    run = lambda: qmm_ops.qmatmul(x, w, delta, bias=b)
    plain = lambda: qmatmul_ref(x, w, delta, bias=b)
    lib = lambda: torch.addmm(bx, x, wdq)
    name = str(dtype).split(".")[-1]
    err = _err(run(), plain(), dtype, f"qmatmul q {m}x{k}x{n} {name}")
    xb = x.element_size()
    nbytes = m * k * xb + k * n + n * 4 * (2 if bias else 1) + m * n * xb
    return {"kernel": "qmatmul", "layout": _counted(
                run, qmm_k, "launches_by_layout"),
            "variant": _counted(run, qmm_k, "launches_by_variant"),
            "shape": f"M={m} K={k} N={n} (q form{', bias' if bias else ''})",
            "dtype": name, "max_abs_err": err,
            "bound_ms": max(nbytes / 3.35e9,
                            _planes(dtype) * 2 * m * k * n / 989e9),
            "ms": _event_ms(run), "device_ms": _device_ms(run),
            "plain_ms": _event_ms(plain),
            "library": f"addmm on the dequantized {name} matrix",
            "library_ms": _event_ms(lib), "library_device_ms": _device_ms(lib)}


def prefill32_case(g, b, t, s, kvh, grp, hd, cache):
    """The fp32 attn_prefill: ragged lengths and hi = min(t + 1, len) for a
    bucket (T = S), or hi = valid against an S-entry cache (T = 5, one row
    without a valid key); SDPA over the dequantized K/V in fp32."""
    dev = torch.device("cuda")
    q = torch.randn((b, t, kvh * grp, hd), generator=g, device=dev)
    if cache == "int8":
        kc, vc = (torch.randint(-127, 128, (b, s, kvh, hd), generator=g,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand((b, s), generator=g, device=dev) * 0.02
                  for _ in range(2))
        kl, vl = kc.float() * ks[..., None, None], vc.float() * vs[..., None, None]
    else:
        kc, vc = (torch.randn((b, s, kvh, hd), generator=g, device=dev)
                  for _ in range(2))
        ks = vs = None
        kl, vl = kc, vc
    if t == s:
        plen = torch.tensor([1, t, t // 2, 3, t - 1, min(17, t), t // 4,
                             min(9, t)], dtype=torch.int32, device=dev)[:b]
        hi = torch.minimum(torch.arange(t, dtype=torch.int32, device=dev)[None]
                           + 1, plen[:, None])
        work = int(hi.sum())
    else:
        lens = torch.tensor([0, 1, 37, 128, 200, 333, 480, s - t],
                            dtype=torch.int32, device=dev)[:b]
        hi = torch.clamp(lens[:, None] + torch.arange(
            1, t + 1, dtype=torch.int32, device=dev)[None], max=s)
        hi[1] = 0
        work = int(hi.sum())
    lo = torch.zeros_like(hi)
    run = lambda: pf_ops.attn_prefill(q, kc, vc, hi, k_scale=ks, v_scale=vs)
    qg = scale_q(q, hd ** -0.5).reshape(b, t, kvh, grp, hd)
    plain = lambda: attn_prefill_ref(qg, kc, vc, lo, hi, ks, vs)
    qs = q.transpose(1, 2)
    kh = kl.transpose(1, 2).repeat_interleave(grp, dim=1)
    vh = vl.transpose(1, 2).repeat_interleave(grp, dim=1)
    mask = (torch.arange(s, device=dev)[None, None, :]
            < hi[:, :, None])[:, None]
    lib = lambda: F.scaled_dot_product_attention(qs, kh, vh, attn_mask=mask)
    err = _err(run(), plain().reshape(b, t, -1, hd), torch.float32,
               f"attn_prefill fp32 T={t} S={s} D={hd} {cache}")
    keys = int(hi.amax(1).sum())
    eb = kc.element_size()
    nbytes = (2 * b * t * kvh * grp * hd * 4 + 2 * keys * kvh * hd * eb
              + (2 * keys * 4 if ks is not None else 0) + b * t * 4)
    return {"kernel": "attn_prefill", "variant": _counted(
                run, pf_k, "launches_by_variant"), "merges": _merges(run),
            "shape": f"B={b} T={t} S={s} KV={kvh} G={grp} D={hd}"
                     + (" (verify, hi = valid)" if t != s else " lens ragged"),
            "dtype": f"float32/kv-{cache}", "max_abs_err": err,
            "bound_ms": max(nbytes / 3.35e9,
                            4 * hd * kvh * grp * work / 67e9),
            "ms": _event_ms(run), "device_ms": _device_ms(run),
            "plain_ms": _event_ms(plain),
            "library": "SDPA (fp32, dequantized K/V, KV heads expanded)",
            "library_ms": _event_ms(lib), "library_device_ms": _device_ms(lib)}


def lse_case(g, shape, cache, dtype):
    """attn_prefill at ``shape`` (verify: hi = valid with one row without a
    valid key; a bucket: ragged lengths) on the kernel ``dtype`` picks:
    its time and output hash without ``with_lse`` (the same lines from two
    trees compare the launch's time and bits), then, where the tree's
    wrapper takes ``with_lse``, the call with it: its time, whether its
    output is the same bits, and the bound with the (B, T, H) fp32
    log-sum-exp written too."""
    import inspect
    b, t, s, kvh, grp, hd = shape
    dev = torch.device("cuda")
    q = torch.randn((b, t, kvh * grp, hd), generator=g, device=dev).to(dtype)
    if cache == "int8":
        kc, vc = (torch.randint(-127, 128, (b, s, kvh, hd), generator=g,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand((b, s), generator=g, device=dev) * 0.02
                  for _ in range(2))
    else:
        kc, vc = (torch.randn((b, s, kvh, hd), generator=g,
                              device=dev).to(dtype) for _ in range(2))
        ks = vs = None
    if t == s:
        plen = torch.tensor([1, t, t // 2, 3, t - 1, min(17, t), t // 4,
                             min(9, t)], dtype=torch.int32, device=dev)[:b]
        hi = torch.minimum(torch.arange(t, dtype=torch.int32, device=dev)[None]
                           + 1, plen[:, None])
    else:
        lens = torch.tensor([0, 1, 37, 128, 200, 333, 480, s - t],
                            dtype=torch.int32, device=dev)[:b]
        hi = torch.clamp(lens[:, None] + torch.arange(
            1, t + 1, dtype=torch.int32, device=dev)[None], max=s)
        hi[1] = 0
    run = lambda: pf_ops.attn_prefill(q, kc, vc, hi, k_scale=ks, v_scale=vs)
    qg = scale_q(q, hd ** -0.5).reshape(b, t, kvh, grp, hd)
    out = run()
    err = _err(out, attn_prefill_ref(qg, kc, vc, torch.zeros_like(hi), hi,
                                     ks, vs).reshape(b, t, -1, hd), dtype,
               f"attn_prefill {dtype} T={t} S={s} {cache}")
    keys = int(hi.amax(1).sum())
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * keys * kvh * hd * kc.element_size()
              + (2 * keys * 4 if ks is not None else 0) + b * t * 4)
    ops = 4 * hd * kvh * grp * int(hi.sum())
    peak = 989e9 if dtype == torch.bfloat16 else 67e9
    rec = {"kernel": "attn_prefill",
           "variant": _counted(run, pf_k, "launches_by_variant"),
           "shape": f"B={b} T={t} S={s} KV={kvh} G={grp} D={hd}"
                    + (" (verify, hi = valid)" if t != s else " lens ragged"),
           "dtype": f"{str(dtype).removeprefix('torch.')}/kv-{cache}",
           "max_abs_err": err, "out_sha": _digest(out),
           "bound_ms": max(nbytes / 3.35e9, ops / peak),
           "ms": _event_ms(run), "device_ms": _device_ms(run)}
    if "with_lse" in inspect.signature(pf_ops.attn_prefill).parameters:
        with_lse = lambda: pf_ops.attn_prefill(q, kc, vc, hi, k_scale=ks,
                                               v_scale=vs, with_lse=True)
        o2, _ = with_lse()
        rec.update(lse_out_same_bits=bool(torch.equal(o2, out)),
                   lse_bound_ms=max((nbytes + b * t * kvh * grp * 4) / 3.35e9,
                                    ops / peak),
                   lse_ms=_event_ms(with_lse),
                   lse_device_ms=_device_ms(with_lse))
    return rec


# The MoE cases are built once here, as parts: ``shape``, ``dtype``, the
# kernel call ``run``, its plain version ``plain`` (the same output shape),
# the ``library`` call and its name ``library_call``, and what the bound
# counts: ``nbytes`` moved and ``ops`` at the ``peak`` of that dtype.
# ``chip_smoke.py`` gates the same parts on the card; ``_timed`` times them.
_PEAK_OPS_MS = {"float32": 67e9, "bfloat16": 989e9}    # operations a ms


def router_parts(g, dev, m, k, n, dtype=torch.bfloat16, what="MoE router"):
    """A row-major (K, N) int8 W of N <= 64 columns (an MoE router, (d, E);
    an MLP head), per-channel delta, x in ``dtype``, fp32 out: qmatmul's
    row-major k_lanes kernel, its products on the tensor cores (fp32 x as
    three bf16 planes, so three times the bf16 operations); ``addmm`` on
    the dequantized W in x's dtype (TF32 off)."""
    w = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                      dtype=torch.int8)
    delta = torch.rand(n, generator=g, device=dev) * 0.01
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    wdq = (w.float() * delta).to(dtype)
    zero = torch.zeros(n, device=dev, dtype=dtype)
    name = str(dtype).removeprefix("torch.")
    return dict(
        shape=f"M={m} K={k} N={n} ({what}, fp32 out)", dtype=name,
        run=lambda: qmm_ops.qmatmul(x, w, delta, out_dtype=torch.float32),
        plain=lambda: qmatmul_ref(x, w, delta, out_dtype=torch.float32),
        library=lambda: torch.addmm(zero, x, wdq),
        library_call=f"addmm on the dequantized {name} W",
        nbytes=m * k * x.element_size() + k * n + n * 4 + m * n * 4,
        ops=2 * m * k * n * _planes(dtype), peak="bfloat16", tol=dtype)


def window_prefill_parts(g, dev, t, window, kvh=8, grp=6, hd=128):
    """A solo prefill's windowed attention: one row of T queries against
    its own T keys, query t seeing max(t - window + 1, 0) <= p <= t, bf16
    (the wgmma kernel); SDPA with the same window as a boolean mask."""
    q = torch.randn((1, t, kvh * grp, hd), generator=g,
                    device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn((1, t, kvh, hd), generator=g,
                          device=dev).to(torch.bfloat16) for _ in range(2))
    pos = torch.arange(t, dtype=torch.int32, device=dev)
    hi, lo = (pos + 1)[None], torch.clamp(pos - (window - 1), min=0)[None]
    qg = scale_q(q, hd ** -0.5).reshape(1, t, kvh, grp, hd)
    kh = kc.transpose(1, 2).repeat_interleave(grp, dim=1)
    vh = vc.transpose(1, 2).repeat_interleave(grp, dim=1)
    mask = ((pos[None, :] < hi[0, :, None])
            & (pos[None, :] >= lo[0, :, None]))[None, None]
    h = kvh * grp
    return dict(
        shape=f"B=1 T=S={t} KV={kvh} G={grp} D={hd} window {window}",
        dtype="bfloat16/kv-bf16",
        run=lambda: pf_ops.attn_prefill(q, kc, vc, hi, lo=lo),
        plain=lambda: attn_prefill_ref(qg, kc, vc, lo, hi).reshape(
            1, t, h, hd),
        library=lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), kh, vh, attn_mask=mask),
        library_call="SDPA with the window mask (KV heads expanded)",
        nbytes=2 * t * h * hd * 2 + 2 * t * kvh * hd * 2 + 2 * t * 4,
        ops=4 * hd * h * int((hi - lo).sum()), peak="bfloat16")


def ring_decode_parts(g, dev, b=8, s=4096, kvh=8, grp=6, hd=128):
    """attn_decode over a full sliding-window ring: every row holds all
    ``s`` entries of a bf16 cache; SDPA over the same cache."""
    lens = torch.full((b,), s, dtype=torch.int32, device=dev)
    q = torch.randn((b, 1, kvh * grp, hd), generator=g,
                    device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn((b, s, kvh, hd), generator=g,
                          device=dev).to(torch.bfloat16) for _ in range(2))
    kh = kc.transpose(1, 2).repeat_interleave(grp, dim=1)
    vh = vc.transpose(1, 2).repeat_interleave(grp, dim=1)
    h = kvh * grp
    return dict(
        shape=f"B={b} S={s} KV={kvh} G={grp} D={hd} full ring",
        dtype="bfloat16/kv-bf16",
        run=lambda: dec_ops.attn_decode(q, kc, vc, lens),
        plain=lambda: attn_decode_ref(q, kc, vc, lens),
        library=lambda: F.scaled_dot_product_attention(q.transpose(1, 2),
                                                       kh, vh),
        library_call="SDPA",
        nbytes=2 * b * h * hd * 2 + 2 * b * s * kvh * hd * 2 + b * 4,
        ops=4 * hd * h * b * s, peak="bfloat16")


def _timed(kernel, parts, **extra):
    """One JSON line for a case built as parts (bf16, held to 2e-2 x
    max|plain|): the bound, the kernel's, its plain version's and the
    library call's times."""
    run, lib = parts["run"], parts["library"]
    out = run()
    err = _err(out, parts["plain"](), parts.get("tol", torch.bfloat16),
               f"{kernel} {parts['shape']}")
    return {"kernel": kernel, **extra, "shape": parts["shape"],
            "dtype": parts["dtype"], "max_abs_err": err,
            "out_sha": _digest(out),
            "bound_ms": max(parts["nbytes"] / 3.35e9,
                            parts["ops"] / _PEAK_OPS_MS[parts["peak"]]),
            "ms": _event_ms(run), "device_ms": _device_ms(run),
            "plain_ms": _event_ms(parts["plain"]),
            "library": parts["library_call"], "library_ms": _event_ms(lib),
            "library_device_ms": _device_ms(lib)}


def router_case(g, m, k, n, dtype=torch.bfloat16, what="MoE router"):
    c = router_parts(g, torch.device("cuda"), m, k, n, dtype, what)
    return _timed("qmatmul", c, orientation=_counted(
        c["run"], qmm_k, "launches_by_orientation"))


def window_prefill_case(g, t, window):
    c = window_prefill_parts(g, torch.device("cuda"), t, window)
    return _timed("attn_prefill", c, variant=_counted(
        c["run"], pf_k, "launches_by_variant"))


def fp32sum_case(g, kernel, m, k, n, dtype=torch.float32):
    """fp32 x on the tensor cores (three bf16 planes), or bf16 x, at a long
    K: the max error over max|out| of the kernel and of its plain version
    (an fp32 matmul) against a float64 product of the same x and levels,
    and the kernel's time; for bf16 x with fp32 output (the sum's error)
    and with bf16 output (as the engine serves). No tolerance: the card
    tests hold fp32 x to 3e-6."""
    dev = torch.device("cuda")
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    delta = torch.rand(n, generator=g, device=dev) * 0.05 + 0.01
    lo, hi = (-4, 4) if kernel == "qmatvec" else (-127, 128)
    lv = torch.randint(lo, hi, (k, n), generator=g, device=dev,
                       dtype=torch.int8)
    if kernel == "qmatvec":
        w = pack_matrix(lv, 3)
        run = lambda out=None: qmv_ops.qmatvec(x, w, delta, k=k,
                                               out_dtype=out)
        plain = lambda out=None: qmatvec_ref(x, w, delta, k, out_dtype=out)
    else:
        w = lv if kernel == "n_lanes" else lv.T.contiguous().T
        run = lambda out=None: qmm_ops.qmatmul(x, w, delta, out_dtype=out)
        plain = lambda out=None: qmatmul_ref(x, w, delta, out_dtype=out)
    ref = x.double() @ (lv.double() * delta.double())
    scale = float(ref.abs().max())
    rel = lambda out: float((out.double() - ref).abs().max()) / scale
    f32 = torch.float32
    rec = {"kernel": "qmatvec" if kernel == "qmatvec" else "qmatmul",
           "layout": kernel, "shape": f"M={m} K={k} N={n}",
           "dtype": str(dtype).removeprefix("torch."), "out_dtype": "float32",
           "max_err_over_max_kernel": rel(run(f32)),
           "max_err_over_max_plain": rel(plain(f32)),
           "reference": "float64"}
    if dtype == torch.bfloat16:
        rec.update(max_err_over_max_kernel_bf16_out=rel(run()),
                   max_err_over_max_plain_bf16_out=rel(plain()))
    return {**rec, "ms": _event_ms(run), "device_ms": _device_ms(run)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="", help="a label printed on each line")
    ap.add_argument("--groups", default="qwen",
                    help="comma-separated: qwen, dense, head, q, "
                         "prefill32, moe, fp32sum, router, decode_g, lse")
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
    if "q" in groups:
        cases += [lambda c=c: q_case(g, *c) for c in Q_CASES]
    if "prefill32" in groups:
        cases += [lambda c=c, kv=kv: prefill32_case(g, *c, kv)
                  for c in PREFILL32_CASES for kv in ("fp32", "int8")]
    if "moe" in groups:
        cases += [lambda c=c: q_case(g, *c, False, torch.bfloat16)
                  for c in MOE_EXPERT_CASES]
        cases += [lambda c=c: router_case(g, *c) for c in MOE_ROUTER_CASES]
        cases += [lambda: window_prefill_case(g, *MOE_WINDOW),
                  lambda: _timed("attn_decode", ring_decode_parts(
                      g, torch.device("cuda")))]
    if "fp32sum" in groups:
        cases += [lambda c=c: fp32sum_case(g, *c) for c in FP32SUM_CASES]
    if "router" in groups:
        cases += [lambda c=c: router_case(g, *c) for c in ROUTER_CASES]
    if "decode_g" in groups:
        cases += [lambda c=c: decode_case(g, *c) for c in DECODE_G_CASES]
    if "lse" in groups:
        cases += [lambda c=c: lse_case(g, *c) for c in LSE_CASES]
    for case in cases:
        print(json.dumps({"tag": args.tag, **case()}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
