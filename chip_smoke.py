#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py              # on a machine with a CUDA card
    python3 chip_smoke.py --rehearse   # CPU rehearsal: reduced model, the
                                       # kernels' plain versions, no result line

Phases, each printing one JSON line:

1. card      the card's name and power limit (nvidia-smi), torch/CUDA
             versions, the kernels' build time (one nvcc per source, all at
             once, for sm_90a). TF32 is switched off for fp32 products.
2. parity    every CUDA kernel against its plain PyTorch version at the
             main path's shapes, in bf16 and fp32 (int8 KV for attention):
             max abs error against the tolerance, held row by row (fp32:
             1e-4 x the row's max|ref|; bf16: 2e-2 x the row's max|ref|, the
             sums run in another order; a row is one output vector of a
             matmul, one query of attention), and the
             median CUDA-event ms of the kernel, the plain version and one
             PyTorch library call computing the same function.
3. engine    full-width qwen2-1.5b, fp32 master weights from a seeded
             generator on the card, exported to W3A8 containers on the
             card, served by ServingEngine(slots=8, max_len=512, bf16) for
             16 requests x 32 new tokens, once with a bf16 KV cache and once
             with kv_bits=8. Launch counters are zeroed just before each run
             and read just after: every kernel must have launched and no
             plain version may have run.
4. path      prefill + 4 decode steps at full width in fp32 activations
             (no activation quant) with all kernels, then with the plain
             paths (matmul_mode="dequant", attn_mode="ref") on the same
             weights: logits must agree (max |diff| <= 2e-3 x max |logit|).
5. kernels   the per-kernel summary line, then the card line as nvidia-smi
             prints it, then the result line
             {"ok": true, "device": {"platform": "gpu", ...}}.

Any failure raises and exits non-zero without a result line; so does a run
without a CUDA card (unless --rehearse), or a directory without the port.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                   # H100 SXM device memory rate
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}   # fp32 non-tensor, bf16 TC
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
KERNEL_META = {
    "qmatvec": ("src/repro_torch/csrc/qmatvec.cu",
                "src/repro/kernels/qmatvec/kernel.py:70"),
    "qmatmul": ("src/repro_torch/csrc/qmatmul.cu",
                "src/repro/kernels/qmatmul/kernel.py:50"),
    "attn_decode": ("src/repro_torch/csrc/attn_decode.cu",
                    "src/repro/kernels/attn_decode/kernel.py:116"),
    "attn_prefill": ("src/repro_torch/csrc/attn_prefill.cu",
                     "src/repro/kernels/attn_prefill/kernel.py:124"),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


class Clock:
    """Median ms of a callable: CUDA events on the card, the host clock in
    the CPU rehearsal (whose numbers are not device times)."""

    def __init__(self, device, reps: int):
        self.device, self.reps = device, reps

    def __call__(self, fn) -> float:
        import torch
        fn()
        if self.device.type != "cuda":
            ts = []
            for _ in range(self.reps):
                t0 = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(ts)
        torch.cuda.synchronize()
        evs = []
        for _ in range(self.reps):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            evs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in evs)


def bound_ms(nbytes: float, ops: float, dtype: str):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / PEAK_OPS[dtype] * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def compare(got, ref, dtype: str, what: str, row_dims: int = 1) -> float:
    """Max abs error of ``got`` against ``ref``. Each row (an index into the
    first ``row_dims`` axes) is held to TOL x its own max|ref|, so rows of
    small outputs are not judged by the scale of large ones; a row whose
    ref is all zeros must come out exactly zero."""
    if not bool(got.float().isfinite().all()):
        fail(f"{what}: non-finite kernel output")
    diff = (got.float() - ref.float()).abs().flatten(row_dims).amax(-1)
    scale = ref.float().abs().flatten(row_dims).amax(-1)
    bad = (~(diff <= TOL[dtype] * scale)).flatten().nonzero()
    if bad.numel():
        i = int(bad[0, 0])
        fail(f"{what}: row {i}: kernel vs plain max abs err "
             f"{float(diff.flatten()[i])} exceeds {TOL[dtype]} x the row's "
             f"max|ref| ({float(scale.flatten()[i])})")
    return float(diff.max())


# --- phase 1 ----------------------------------------------------------------------

def card_phase(device, rehearse: bool):
    import torch
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"phase": "card", "torch": torch.__version__,
            "cuda": torch.version.cuda, "allow_tf32": False}
    from repro_torch.launch.profile_engine import card_line
    smi = "not measured (CPU rehearsal)"
    if not rehearse:
        smi = card_line()
        info["device_name"] = torch.cuda.get_device_name(0)
        t0 = time.perf_counter()
        secs = _build.build()
        info["build_s"] = round(time.perf_counter() - t0, 3)
        info["nvcc_s"] = {k: round(v, 3) for k, v in secs.items()}
        info["ptxas"] = {k: [ln.strip() for ln in v.splitlines()
                             if "registers" in ln or "spill" in ln][:4]
                         for k, v in _build.build_log.items()}
    info["nvidia_smi"] = smi
    emit(info)
    return smi


# --- phase 2 ----------------------------------------------------------------------

def _kernel_cases(cfg, device, clock):
    """Yield one dict per (kernel, shape, dtype) case."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.packing import pack_matrix, unpack_matrix
    from repro_torch.kernels.attn_decode import ops as dec_ops
    from repro_torch.kernels.attn_decode.ref import attn_decode_ref
    from repro_torch.kernels.attn_prefill import ops as pf_ops
    from repro_torch.kernels.attn_prefill.ref import attn_prefill_ref
    from repro_torch.kernels.attn_decode.ref import scale_q
    from repro_torch.kernels.qmatmul import ops as qmm_ops
    from repro_torch.kernels.qmatmul.ref import qmatmul_ref
    from repro_torch.kernels.qmatvec import ops as qmv_ops
    from repro_torch.kernels.qmatvec.ref import qmatvec_ref

    g = torch.Generator(device=device).manual_seed(1234)
    d, hd = cfg.d_model, cfg.head_dim
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    dts = [("bfloat16", torch.bfloat16), ("float32", torch.float32)]

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    # qmatvec: the 7 projection shapes (4 distinct), decode and prefill M
    for k, n in ((d, h * hd), (d, kvh * hd), (d, cfg.d_ff), (cfg.d_ff, d)):
        lv = torch.randint(-3, 4, (k, n), generator=g, device=device,
                           dtype=torch.int8)
        w = pack_matrix(lv, 3)
        delta = torch.rand(n, generator=g, device=device) * 0.05
        bias = randn(n)
        for m in (8, 8 * 64):
            for dname, dt in dts:
                x = randn(m, k, dtype=dt)
                got = qmv_ops.qmatvec(x, w, delta, k=k, bias=bias)
                ref = qmatvec_ref(x, w, delta, k, bias=bias)
                wdq = (unpack_matrix(w, k, 3).float() * delta).to(dt)
                bx = bias.to(dt)
                xb = x.element_size()
                nbytes = m * k * xb + w.numel() * 4 + 2 * n * 4 + m * n * xb
                yield dict(
                    name="qmatvec", shape=f"M={m} K={k} N={n}", dtype=dname,
                    err=compare(got, ref, dname, f"qmatvec {m}x{k}x{n} {dname}"),
                    ms=clock(lambda: qmv_ops.qmatvec(x, w, delta, k=k, bias=bias)),
                    plain_ms=clock(lambda: qmatvec_ref(x, w, delta, k, bias=bias)),
                    library_ms=clock(lambda: torch.addmm(bx, x, wdq)),
                    bound=bound_ms(nbytes, 2 * m * k * n, dname),
                    headline=(m == 8 and n == cfg.d_ff and dname == "bfloat16"))

    # qmatmul: the tied readout, (slots, D) x (D, V) as the transposed view
    table = torch.randint(-127, 128, (cfg.vocab_size, d), generator=g,
                          device=device, dtype=torch.int8)
    for dname, dt in dts:
        hs = randn(8, d, dtype=dt)
        got = qmm_ops.qmatmul(hs, table.T, 1.0)
        ref = qmatmul_ref(hs, table.T, 1.0)
        tdq = table.to(dt)
        xb = hs.element_size()
        nbytes = 8 * d * xb + table.numel() + cfg.vocab_size * 4 \
            + 8 * cfg.vocab_size * xb
        yield dict(
            name="qmatmul", shape=f"M=8 K={d} N={cfg.vocab_size} (q.T view)",
            dtype=dname, err=compare(got, ref, dname, f"qmatmul {dname}"),
            ms=clock(lambda: qmm_ops.qmatmul(hs, table.T, 1.0)),
            plain_ms=clock(lambda: qmatmul_ref(hs, table.T, 1.0)),
            library_ms=clock(lambda: torch.matmul(hs, tdq.T)),
            bound=bound_ms(nbytes, 2 * 8 * d * cfg.vocab_size, dname),
            headline=dname == "bfloat16")
    del table

    # attn_decode: 8 slots, S = 512, ragged lengths with one empty row
    b, s = 8, 512
    lens = torch.tensor([0, 1, 37, 128, 200, 333, 511, 512], dtype=torch.int32,
                        device=device)
    grp = h // kvh
    for kvname, dname, dt in (("bf16", "bfloat16", torch.bfloat16),
                              ("int8", "bfloat16", torch.bfloat16),
                              ("fp32", "float32", torch.float32),
                              ("int8", "float32", torch.float32)):
        q = randn(b, 1, h, hd, dtype=dt)
        if kvname == "int8":
            kc = torch.randint(-127, 128, (b, s, kvh, hd), generator=g,
                               device=device, dtype=torch.int8)
            vc = torch.randint(-127, 128, (b, s, kvh, hd), generator=g,
                               device=device, dtype=torch.int8)
            ks = torch.rand((b, s), generator=g, device=device) * 0.02
            vs = torch.rand((b, s), generator=g, device=device) * 0.02
            kl = (kc.float() * ks[..., None, None]).to(dt)
            vl = (vc.float() * vs[..., None, None]).to(dt)
        else:
            kc, vc, ks, vs = randn(b, s, kvh, hd, dtype=dt), \
                randn(b, s, kvh, hd, dtype=dt), None, None
            kl, vl = kc, vc
        got = dec_ops.attn_decode(q, kc, vc, lens, ks, vs)
        ref = attn_decode_ref(q, kc, vc, lens, ks, vs)
        # library yardstick: SDPA over the (dequantized) cache, KV heads
        # expanded to the query heads beforehand
        qs = q.transpose(1, 2)
        kh = kl.transpose(1, 2).repeat_interleave(grp, dim=1)
        vh = vl.transpose(1, 2).repeat_interleave(grp, dim=1)
        mask = (torch.arange(s, device=device)[None, :]
                < lens[:, None])[:, None, None, :]
        tot = int(lens.sum())
        eb = kc.element_size()
        nbytes = (2 * b * h * hd * q.element_size() + 2 * tot * kvh * hd * eb
                  + (2 * tot * 4 if ks is not None else 0) + b * 4)
        yield dict(
            name="attn_decode", shape=f"B={b} S={s} KV={kvh} G={grp} D={hd} "
                                      f"lens ragged (one 0)",
            dtype=f"{dname}/kv-{kvname}",
            err=compare(got, ref, dname, f"attn_decode {dname} kv-{kvname}"),
            ms=clock(lambda: dec_ops.attn_decode(q, kc, vc, lens, ks, vs)),
            plain_ms=clock(lambda: attn_decode_ref(q, kc, vc, lens, ks, vs)),
            library_ms=clock(lambda: F.scaled_dot_product_attention(
                qs, kh, vh, attn_mask=mask)),
            bound=bound_ms(nbytes, 4 * hd * h * tot, dname),
            headline=(kvname == "bf16" and dname == "bfloat16"))

    # attn_prefill: B = 8, T = S in {64, 256}, ragged lengths, hi = min(t+1, len)
    for t in (64, 256):
        plen = torch.tensor([1, t, t // 2, 3, t - 1, 17, t // 4, 9],
                            dtype=torch.int32, device=device)
        pos = torch.arange(t, dtype=torch.int32, device=device)
        hi = torch.minimum(pos[None, :] + 1, plen[:, None])
        lo = torch.zeros_like(hi)
        for dname, dt in dts:
            q = randn(b, t, h, hd, dtype=dt)
            k_ = randn(b, t, kvh, hd, dtype=dt)
            v_ = randn(b, t, kvh, hd, dtype=dt)
            got = pf_ops.attn_prefill(q, k_, v_, hi)
            qg = scale_q(q, hd ** -0.5).reshape(b, t, kvh, grp, hd)
            ref = attn_prefill_ref(qg, k_, v_, lo, hi).reshape(b, t, h, hd)
            qs = q.transpose(1, 2)
            kh = k_.transpose(1, 2).repeat_interleave(grp, dim=1)
            vh = v_.transpose(1, 2).repeat_interleave(grp, dim=1)
            mask = (pos[None, None, :] < hi[:, :, None])[:, None]
            eb = q.element_size()
            nbytes = (2 * b * t * h * hd * eb
                      + 2 * int(plen.sum()) * kvh * hd * eb + 2 * b * t * 4)
            ops = 4 * hd * h * int((hi - lo).sum())
            yield dict(
                name="attn_prefill", shape=f"B={b} T=S={t} KV={kvh} G={grp} "
                                           f"D={hd} lens ragged",
                dtype=dname, err=compare(got, ref, dname,
                                         f"attn_prefill T={t} {dname}",
                                         row_dims=2),
                ms=clock(lambda: pf_ops.attn_prefill(q, k_, v_, hi)),
                plain_ms=clock(lambda: attn_prefill_ref(qg, k_, v_, lo, hi)),
                library_ms=clock(lambda: F.scaled_dot_product_attention(
                    qs, kh, vh, attn_mask=mask)),
                bound=bound_ms(nbytes, ops, dname),
                headline=(t == 256 and dname == "bfloat16"))


def parity_phase(cfg, device, rehearse):
    clock = Clock(device, reps=3 if rehearse else 20)
    cases = []
    for c in _kernel_cases(cfg, device, clock):
        c["bound_ms"], c["bound_by"] = c.pop("bound")
        cases.append(c)
    emit({"phase": "parity", "tolerance": TOL,
          "timing": "median ms, CUDA events" if not rehearse
          else "median ms, host clock (CPU rehearsal, not device times)",
          "cases": [{k: v for k, v in c.items() if k != "headline"}
                    for c in cases]})
    return {c["name"]: c for c in cases if c["headline"]}


# --- phase 3 ----------------------------------------------------------------------

def _counters():
    from repro_torch.kernels.attn_decode import kernel as k1, ref as r1
    from repro_torch.kernels.attn_prefill import kernel as k2, ref as r2
    from repro_torch.kernels.qmatmul import kernel as k3, ref as r3
    from repro_torch.kernels.qmatvec import kernel as k4, ref as r4
    return {"qmatvec": (k4, r4), "qmatmul": (k3, r3),
            "attn_decode": (k1, r1), "attn_prefill": (k2, r2)}


def reset_counts():
    for kmod, rmod in _counters().values():
        kmod.launches = 0
        rmod.calls = 0


def read_counts():
    c = _counters()
    return ({n: km.launches for n, (km, _) in c.items()},
            {n: rm.calls for n, (_, rm) in c.items()})


def build_model(cfg, device, seed):
    import torch
    from repro_torch.core import quant_dense
    from repro_torch.core.precision import W3A8
    from repro_torch.models import get_model
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    master = get_model(cfg).init(gen, cfg, device=device)
    params = quant_dense.export_container(master, W3A8)
    del master
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return params, time.perf_counter() - t0


def engine_phase(cfg, params, device, kv_bits, rehearse):
    import torch
    from repro_torch.core.precision import W3A8
    from repro_torch.launch.profile_engine import MAX_NEW, prompts
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(params, cfg, policy=W3A8, slots=8, max_len=512,
                        dtype=torch.bfloat16, kv_bits=kv_bits, device=device)
    reqs = prompts(cfg.vocab_size)
    if device.type == "cuda":
        torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for p in reqs:
        eng.submit(p, max_new=MAX_NEW)
    done = eng.run_all()
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = read_counts()
    toks = sum(len(r.out) for r in done)
    out = {"phase": "engine", "kv": "int8" if kv_bits else "bf16",
           "requests": len(done), "tokens": toks,
           "decode_calls": eng.decode_calls,
           "prefill_calls": eng.prefill_calls,
           "wall_s": round(wall, 4), "tok_per_s": round(toks / wall, 2),
           "launches": launches, "plain_calls": plain}
    emit(out)
    if len(done) != len(reqs) or any(len(r.out) != MAX_NEW for r in done):
        fail(f"engine did not serve every request its {MAX_NEW} tokens")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.out):
        fail("engine emitted a token id outside the vocabulary")
    if not rehearse:
        if min(launches.values()) <= 0:
            fail(f"a kernel of the main path never launched: {launches}")
        if max(plain.values()) != 0:
            fail(f"a plain version ran on the main path: {plain}")
    return launches, {r.uid: r.out for r in done}


# --- phase 4 ----------------------------------------------------------------------

def path_phase(cfg, params, device):
    import dataclasses

    import torch
    from repro_torch.core.precision import W3A8
    from repro_torch.models import api
    policy = dataclasses.replace(W3A8, act_bits=None)
    lens = [4, 8, 5, 12, 3, 16, 40, 64]
    toks = torch.zeros((8, 64), dtype=torch.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = torch.arange(n) % (cfg.vocab_size - 1) + 1 + i
    toks = toks.to(device)
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)
    runs = {}
    feed = None
    for name, mm, am in (("kernel", "kernel", "kernel"),
                         ("plain", "dequant", "ref")):
        kw = dict(policy=policy, dtype=torch.float32, matmul_mode=mm,
                  attn_mode=am)
        logits, cache = api.prefill(params, {"tokens": toks}, cfg, max_len=96,
                                    lengths=lengths, **kw)
        steps = [logits]
        tok_seq = feed or []
        for i in range(4):
            nxt = (steps[-1][:, -1].argmax(-1).to(torch.int32)[:, None]
                   if feed is None else tok_seq[i])
            if feed is None:
                tok_seq.append(nxt)
            logits, cache = api.decode_step(params, cache, nxt, cfg, **kw)
            steps.append(logits)
        feed = tok_seq
        runs[name] = torch.stack([s[:, -1] for s in steps])   # (5, B, V)
    a, b = runs["kernel"].float(), runs["plain"].float()
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    emit({"phase": "path", "activations": "float32", "act_bits": None,
          "steps": "prefill + 4 decode", "max_abs_logit_diff": err,
          "max_abs_logit": scale, "tolerance": "2e-3 x max|logit|",
          "greedy_agreement": agree})
    if not (a.isfinite().all() and b.isfinite().all()):
        fail("non-finite logits on the path-parity run")
    if not err <= 2e-3 * scale:
        fail(f"kernel path vs plain path logits differ by {err} "
             f"(> 2e-3 x {scale})")


# --- main -------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at reduced size through the plain "
                         "versions; prints no result line")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not args.rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false); use --rehearse for the CPU rehearsal", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config, reduced

    device = torch.device("cpu" if args.rehearse else "cuda")
    cfg = get_config("qwen2-1.5b")
    if args.rehearse:
        cfg = reduced(cfg)
    smi = card_phase(device, args.rehearse)
    headline = parity_phase(cfg, device, args.rehearse)
    params, build_s = build_model(cfg, device, args.seed)
    emit({"phase": "model", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "form": "qp (W3A8 export_container)", "init_export_s":
          round(build_s, 3)})
    launches, _ = engine_phase(cfg, params, device, None, args.rehearse)
    engine_phase(cfg, params, device, 8, args.rehearse)
    path_phase(cfg, params, device)
    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        c = headline[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": c["err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"], "shape": c["shape"],
            "dtype": c["dtype"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    if args.rehearse:
        print("chip_smoke: CPU rehearsal passed (no device result)",
              flush=True)
        return 0
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
