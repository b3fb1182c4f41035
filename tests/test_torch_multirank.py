"""The port's distributed layer on four ranks: one subprocess spawns four
gloo processes on the CPU once (the reference's multi-device tests force
host devices the same way; it uses 8 for its elastic test, 4 here keep
the spawn cheap) and runs every check; each test reads its check's
numbers. Nothing here imports JAX: the sharded paths are held against the
port's own unsharded paths, which the other ``test_torch_*`` files hold
against JAX.

- elastic: parameters placed under a (2, 2) mesh and saved, restored onto
  (4, 1) and (1, 4) with ``restore(shardings=)``: every leaf identical,
  every placement the new mesh's specs', and a reduced qwen2 forward in
  fp32 on the new mesh within 1e-5 x max|logit| of the unsharded one;
- cells: the reduced decode (``qp``, 5 steps) and prefill (``q``) cells of
  ``launch.steps.build_cell`` on (1, 4) and (2, 2), with qwen2's 2 KV
  heads (replicated by the guard on a 4-way model axis) and with 4
  (sharded), through the kernels' wrappers on the shards ('kernel': on
  the CPU their plain versions), and with 2 KV heads also through
  DTensor's own dispatch of the plain paths ('auto'): logits and caches
  within 1e-5 x max|logit|; decode attention merges the ranks' keys by
  log-sum-exp, with no gather of the cache;
- pipeline: ``pipeline_apply`` over a 4-stage mesh, S, M, B, D = 4, 6, 2,
  8 (the reference's test): forward and gradient within 1e-4 of
  sequential application;
- ``compressed_psum`` over the data dim: the int32 sum of the ranks' int8
  payloads times the mean scale;
- data parallel: two W3A8 train steps (frozen deltas) on (4, 1) and on
  (2, 2) (data and tensor parallel) equal one process on the global batch
  within 1e-5; and two steps of a reduced mamba2 on (2, 2), its SSD core
  and projections as local-shard products (``shards.einsum``, forward and
  backward);
- decode on a sequence-sharded cache: ``decode_attention`` with the cache
  placed as the serve cells place it (batch over data, sequence over
  model) on (1, 4) and (2, 2), ragged lengths (a row with no key, one
  whose keys all lie on one rank), bf16 and int8 K/V, in both modes:
  within 1e-5 of the unsharded call, with no gather of the cache;
- verify on a sequence-sharded cache: ``verify_step`` against the cache
  placed as the decode cells place it on (2, 2), bf16 and int8 cache, in
  both modes: within 1e-5 of one process, the cache never gathered;
- ``constrain`` on DTensors: the table's placements, an axis that does
  not divide its dim dropped.
"""
import json
import os
import signal
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
# the 4-rank run's limit: a hang (a rank that skipped a collective) fails
# the run's tests instead of eating the suite's clock
TIMEOUT_S = 300

SCRIPT = r'''
import dataclasses, json, os, sys, tempfile
import torch, torch.distributed as dist, torch.multiprocessing as mp


def relerr(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def elastic(cfg, out):
    from repro_torch import checkpoint
    from repro_torch.core.precision import FLOAT
    from repro_torch.core.treeutil import flatten_with_path
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import place
    from repro_torch.models import get_model
    mod = get_model(cfg)
    params = mod.init(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (4, 8),
                         generator=torch.Generator().manual_seed(1))
    ref, _ = mod.forward(params, {"tokens": toks}, cfg, policy=FLOAT,
                         dtype=torch.float32, remat="none")
    mesh_a = make_host_mesh(2, 2, device="cpu")
    placed = place(params, shd.tree_shardings(
        mesh_a, shd.param_specs(cfg, params, mesh_a)))
    td = tempfile.mkdtemp(prefix=f"elastic{dist.get_rank()}_")
    checkpoint.save(td, 1, {"params": placed})
    for shape in ((4, 1), (1, 4)):
        mesh_b = make_host_mesh(*shape, device="cpu")
        sh = shd.tree_shardings(mesh_b, shd.param_specs(cfg, params, mesh_b))
        tree, meta = checkpoint.restore(td, shardings={"params": sh})
        new, old = flatten_with_path(tree["params"]), \
            flatten_with_path(params)
        same = all(torch.equal(full(new[k]), old[k]) for k in old)
        flat_sh = flatten_with_path(sh)
        placed_ok = all(list(new[k].placements) == flat_sh[k][1]
                        and new[k].device_mesh == mesh_b for k in old)
        with _on(mesh_b, cfg, 4, "train"):
            got, _ = mod.forward(tree["params"], {"tokens": toks}, cfg,
                                 policy=FLOAT, dtype=torch.float32,
                                 remat="none")
        out[f"elastic_{shape[0]}x{shape[1]}"] = {
            "identical": same, "placements": placed_ok,
            "step": meta["step"], "rel_err": relerr(full(got), ref)}


def _on(mesh, cfg, batch, kind):
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.steps import _on_mesh, _rules_ctx
    return _on_mesh(_rules_ctx(cfg, ShapeConfig(kind, 8, batch, kind), mesh))


def cells(cfg, kv_name, modes, out):
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import quant_dense
    from repro_torch.core.precision import W3A8
    from repro_torch.distributed import shards
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.models.api import init_cache
    mod = get_model(cfg)
    master = mod.init(torch.Generator().manual_seed(0), cfg)
    levels = quant_dense.export_levels(master, W3A8)
    words = quant_dense.export_container(master, W3A8)
    b, t, s = 4, 8, 16
    prompt = torch.randint(0, cfg.vocab_size, (b, t), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(3))
    for shape in ((1, 4), (2, 2)):
        mesh = make_host_mesh(*shape, device="cpu")
        for mode in modes:
            shards.gathers.clear()
            kw = dict(matmul_mode=mode, attn_mode=mode)
            cell = steps.build_cell(cfg, ShapeConfig("p", t, b, "prefill"),
                                    mesh, **kw)
            rl, rc = mod.prefill(levels, {"tokens": prompt}, cfg,
                                 policy=W3A8, dtype=torch.bfloat16,
                                 max_len=t, **kw)
            lo, c = cell.fn(steps.place(levels, cell.in_shardings[0]),
                            steps.place({"tokens": prompt},
                                        cell.in_shardings[1]))
            scale = float(rl.abs().max())
            pre = max(float((full(lo) - rl).abs().max()),
                      float((full(c["k"]).float() - rc["k"].float()).abs()
                            .max()), float((full(c["v"]).float()
                                            - rc["v"].float()).abs().max()))
            dcell = steps.build_cell(cfg, ShapeConfig("d", s, b, "decode"),
                                     mesh, **kw)
            ref_c = init_cache(cfg, b, s, torch.bfloat16)
            dc = steps.place(init_cache(cfg, b, s, torch.bfloat16),
                             dcell.in_shardings[1])
            dp = steps.place(words, dcell.in_shardings[0])
            dec, dscale = 0.0, 0.0
            for i in range(5):
                tok = prompt[:, i:i + 1]
                rl2, ref_c = mod.decode_step(words, ref_c, tok, cfg,
                                             policy=W3A8,
                                             dtype=torch.bfloat16, **kw)
                l2, dc = dcell.fn(dp, dc, steps.place(
                    {"tokens": tok}, dcell.in_shardings[2]))
                dscale = max(dscale, float(rl2.abs().max()))
                dec = max(dec, float((full(l2) - rl2).abs().max()))
            dec = max(dec, float((full(dc["k"]).float()
                                  - ref_c["k"].float()).abs().max()),
                      float((full(dc["v"]).float()
                             - ref_c["v"].float()).abs().max()))
            out[f"cell_{kv_name}_{shape[0]}x{shape[1]}_{mode}"] = {
                "prefill_rel": pre / scale, "decode_rel": dec / dscale,
                "cache_placements": [repr(p) for p in dc["k"].placements],
                "gathers": dict(shards.gathers)}


def pipeline(out):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.pipeline import pipeline_apply
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("stage",))
    g = torch.Generator().manual_seed(0)
    S, M, B, D = 4, 6, 2, 8
    ws = (torch.randn(S, D, D, generator=g) * 0.3).requires_grad_(True)
    bs = torch.randn(S, D, generator=g) * 0.1
    x = torch.randn(M, B, D, generator=g)
    fn = lambda p, h: torch.tanh(h @ p["w"] + p["b"])
    o = pipeline_apply(fn, {"w": ws, "b": bs}, x, mesh)
    (o ** 2).sum().backward()
    gp = ws.grad.clone()
    dist.all_reduce(gp)             # each stage's rank holds its own row
    w2 = ws.detach().clone().requires_grad_(True)
    h = x
    for i in range(S):
        h = torch.tanh(h @ w2[i] + bs[i])
    (h ** 2).sum().backward()
    out["pipeline"] = {"fwd": float((o - h).abs().max()),
                       "grad": float((gp - w2.grad).abs().max())}


def psum(out):
    from repro_torch.distributed.compression import (compressed_psum,
                                                     quantize_grad)
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(4, 1, device="cpu")
    gs = [torch.randn(33, 7, generator=torch.Generator().manual_seed(r))
          * (r + 1) for r in range(4)]
    got = compressed_psum(gs[dist.get_rank()], mesh, "data")
    qs = [quantize_grad(g) for g in gs]
    total = sum(q.to(torch.int32) for q, _ in qs)
    want = total.to(torch.float32) * (sum(s for _, s in qs) / 4)
    out["psum"] = {"rel_err": relerr(got, want),
                   "int_sum_exact": bool(torch.equal(
                       torch.round(got / (sum(s for _, s in qs) / 4)),
                       total.to(torch.float32)))}


def seq_decode(out):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.distributed import shards
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.attention import decode_attention
    g = torch.Generator().manual_seed(7)
    b, s, kvh, grp, d = 4, 16, 2, 3, 16
    lens = torch.tensor([0, 3, 11, 16], dtype=torch.int32)
    q = torch.randn(b, 1, kvh * grp, d, generator=g).to(torch.bfloat16)
    kf = torch.randn(b, s, kvh, d, generator=g)
    vf = torch.randn(b, s, kvh, d, generator=g)
    res = {}
    for kv in ("bf16", "int8"):
        if kv == "int8":
            k_, v_ = (torch.randint(-127, 128, (b, s, kvh, d), generator=g,
                                    dtype=torch.int8) for _ in range(2))
            ks, vs = (torch.rand(b, s, generator=g) * 0.02 for _ in range(2))
        else:
            k_, v_, ks, vs = kf.to(torch.bfloat16), vf.to(torch.bfloat16), \
                None, None
        for shape in ((1, 4), (2, 2)):
            mesh = make_host_mesh(*shape, device="cpu")
            cpl = [Shard(0) if shape[0] > 1 else Replicate(), Shard(1)]
            qpl = [Shard(0) if shape[0] > 1 else Replicate(), Replicate()]
            place = lambda t, pl: distribute_tensor(t, mesh, pl,
                                                    src_data_rank=None)
            for mode in ("kernel", "ref"):
                shards.gathers.clear()
                want = decode_attention(q, k_, v_, lens, ks, vs, mode=mode)
                got = decode_attention(
                    place(q, qpl), place(k_, cpl), place(v_, cpl),
                    place(lens, qpl[:1] + [Replicate()]),
                    None if ks is None else place(ks, cpl),
                    None if vs is None else place(vs, cpl), mode=mode)
                res[f"{kv}_{shape[0]}x{shape[1]}_{mode}"] = {
                    "rel_err": relerr(full(got).float(), want.float()),
                    "empty_row_zero": bool((full(got)[0] == 0).all()),
                    "gathers": dict(shards.gathers)}
    # the kernel's own merge of (output, log-sum-exp) pairs, as the card
    # runs it, on the plain version's pairs: fp32, within 1e-5
    from repro_torch.kernels.attn_decode.ref import attn_decode_ref
    qf, kf32, vf32 = q.float(), kf, vf
    want = attn_decode_ref(qf, kf32, vf32, lens)
    mesh = make_host_mesh(1, 4, device="cpu")
    r = dist.get_rank()
    sl = slice(4 * r, 4 * r + 4)
    o, lse = attn_decode_ref(qf, kf32[:, sl], vf32[:, sl],
                             torch.clamp(lens - 4 * r, 0, 4), with_lse=True)
    red = lambda t, op: shards._reduce(t, mesh, [1], op)
    big = red(lse, "max")
    w = torch.where(lse > float("-inf"), torch.exp(lse - big),
                    torch.zeros(()))
    num = red(o.float() * w[:, None, :, None], "sum")
    den = red(w, "sum")[:, None, :, None]
    got = torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                      torch.zeros(()))
    res["lse_merge_fp32"] = {"rel_err": relerr(got, want),
                             "empty_row_zero": bool((got[0] == 0).all()),
                             "gathers": {}}
    out["seq_decode"] = res


def seq_verify(cfg, out):
    """``verify_step`` (T = 5) of the reduced qwen2 (its qp export, fp32
    compute) against a (4, 16) cache placed as the decode cells place it
    on (2, 2): batch over data, sequence over model; ragged lengths (a row
    with no cached key, one whose keys all lie on the first model rank,
    one that spans both), bf16 and int8 cache, both attention modes."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import quant_dense
    from repro_torch.core.precision import W3A8
    from repro_torch.distributed import shards
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.models.api import init_cache
    mod = get_model(cfg)
    words = quant_dense.export_container(
        mod.init(torch.Generator().manual_seed(0), cfg), W3A8)
    b, s, t = 4, 16, 5
    g = torch.Generator().manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (b, t), dtype=torch.int32,
                         generator=g)
    lens = torch.tensor([0, 2, 7, 11], dtype=torch.int32)
    mesh = make_host_mesh(2, 2, device="cpu")
    shape = ShapeConfig("d", s, b, "decode")
    for kv in ("bf16", "int8"):
        kv8 = kv == "int8"
        cache = init_cache(cfg, b, s, torch.bfloat16,
                           kv_bits=8 if kv8 else None)
        for name in ("k", "v"):
            cache[name].copy_(torch.randint(-127, 128, cache[name].shape,
                                            generator=g).to(torch.int8)
                              if kv8 else torch.randn(cache[name].shape,
                                                      generator=g))
        for name in ("k_scale", "v_scale"):
            if name in cache:
                cache[name].copy_(torch.rand(cache[name].shape,
                                             generator=g) * 0.02)
        cache["len"] = lens.clone()
        for mode in ("kernel", "ref"):
            kw = dict(matmul_mode=mode if mode == "kernel" else "dequant",
                      attn_mode=mode)
            cell = steps.build_cell(cfg, shape, mesh, kv8=kv8, **kw)
            ref_c = {k: v.clone() for k, v in cache.items()}
            want, _, _ = mod.verify_step(words, ref_c, toks, cfg,
                                         policy=W3A8, dtype=torch.float32,
                                         **kw)
            shards.gathers.clear()
            dc = steps.place({k: v.clone() for k, v in cache.items()},
                             cell.in_shardings[1])
            with steps._on_mesh(steps._rules_ctx(cfg, shape, mesh)):
                got, dc, _ = mod.verify_step(
                    steps.place(words, cell.in_shardings[0]), dc,
                    steps.place({"tokens": toks},
                                cell.in_shardings[2])["tokens"], cfg,
                    policy=W3A8, dtype=torch.float32, **kw)
            out[f"seq_verify_{kv}_{mode}"] = {
                "rel_err": relerr(full(got), want),
                "cache_rel": max(relerr(full(dc[n]).float(), ref_c[n].float())
                                 for n in cache if n != "len"),
                "cache_placements": [repr(p) for p in dc["k"].placements],
                "gathers": dict(shards.gathers)}


def mamba2_step(out):
    from repro_torch.configs import ShapeConfig, TrainConfig, get_config, \
        reduced
    from repro_torch.core import quant_dense
    from repro_torch.core.precision import W3A8
    from repro_torch.core.treeutil import flatten_with_path
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import mesh_step, place
    from repro_torch.models import get_model
    from repro_torch.training.loop import make_train_step
    cfg = reduced(get_config("mamba2-2.7b"), layers=2, d_model=64,
                  vocab=128)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=1, total_steps=10)
    mod = get_model(cfg)

    def fresh():
        p = mod.init(torch.Generator().manual_seed(0), cfg)
        step, init = make_train_step(cfg, tcfg, W3A8, dtype=torch.float32)
        return step, init(p, {"deltas": quant_dense.fit_deltas_stacked(
            p, W3A8)})
    batches = [lm_batch(0, i, batch=8, seq=16, vocab=cfg.vocab_size)
               for i in range(2)]
    step, st = fresh()
    ref = [step(st, b)[1] for b in batches]
    ref_p = {k: v.clone() for k, v in flatten_with_path(st["params"]).items()}
    mesh = make_host_mesh(2, 2, device="cpu")
    step, st = fresh()
    st = place(st, shd.tree_shardings(mesh, shd.state_specs(cfg, st, mesh)))
    run = mesh_step(step, cfg, ShapeConfig("t", 16, 8, "train"), mesh)
    got = [run(st, b)[1] for b in batches]
    errs = [abs(float(g[k]) - float(r[k])) / abs(float(r[k]))
            for g, r in zip(got, ref) for k in ("loss", "gnorm")]
    out["mamba2_dp_2x2"] = {
        "metric_rel": max(errs),
        "param_rel": max(relerr(full(v), ref_p[k]) for k, v in
                         flatten_with_path(st["params"]).items()),
        "steps": int(full(st["step"]))}


def data_parallel(cfg, out):
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.core import quant_dense
    from repro_torch.core.precision import W3A8
    from repro_torch.core.treeutil import flatten_with_path
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import mesh_step, place
    from repro_torch.models import get_model
    from repro_torch.training.loop import make_train_step
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=1, total_steps=10)
    mod = get_model(cfg)

    def fresh():
        p = mod.init(torch.Generator().manual_seed(0), cfg)
        step, init = make_train_step(cfg, tcfg, W3A8, dtype=torch.float32)
        return step, init(p, {"deltas": quant_dense.fit_deltas_stacked(
            p, W3A8)})
    batches = [lm_batch(0, i, batch=8, seq=16, vocab=cfg.vocab_size)
               for i in range(2)]
    step, st = fresh()
    ref, ref_ps = [], []
    for b in batches:
        ref.append(step(st, b)[1])
        ref_ps.append({k: v.clone() for k, v in
                       flatten_with_path(st["params"]).items()})
    for shape, n in (((4, 1), 2), ((2, 2), 2)):
        mesh = make_host_mesh(*shape, device="cpu")
        step, st = fresh()
        st = place(st, shd.tree_shardings(mesh, shd.state_specs(cfg, st,
                                                                 mesh)))
        run = mesh_step(step, cfg, ShapeConfig("t", 16, 8, "train"), mesh)
        got = [run(st, b)[1] for b in batches[:n]]
        ref_p = ref_ps[n - 1]
        errs = [abs(float(g[k]) - float(r[k])) / abs(float(r[k]))
                for g, r in zip(got, ref) for k in ("loss", "gnorm")]
        perr = {k: relerr(full(v), ref_p[k])
                for k, v in flatten_with_path(st["params"]).items()}
        kb = "layers/attn/wk/b"
        out[f"dp_{shape[0]}x{shape[1]}"] = {
            "metric_rel": max(errs), "key_bias_rel": perr.pop(kb),
            "param_rel": max(perr.values()), "steps": int(full(st["step"])),
            "want_steps": n}


def constrain_check(out):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.distributed import context, sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(2, 2, device="cpu")
    table = {"act": shd.P("data", None, "model"), "__mesh__": mesh}
    res = {}
    for shape in ((4, 6, 8), (3, 6, 8), (4, 6, 5)):
        x = distribute_tensor(torch.randn(*shape), mesh,
                              [Replicate(), Replicate()])
        with context.sharding_rules(table):
            y = context.constrain(x, "act")
        res["x".join(map(str, shape))] = [repr(p) for p in y.placements]
        assert torch.equal(y.full_tensor(), x.full_tensor())
    out["constrain"] = res


def run(rank, world, port, q):
    """One rank. An exception is sent to the parent before the rank dies:
    the spawn does not report it (join=False), and the other ranks then
    wait in their next collective, which looked like a hang."""
    try:
        checks(rank, world, port, q)
    except BaseException:
        import traceback
        q.put({"error": f"rank {rank}: {traceback.format_exc()}"})
        raise


def checks(rank, world, port, q):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    torch.set_num_threads(1)
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config("qwen2-1.5b"), layers=2, d_model=64, vocab=128)
    out = {}
    elastic(cfg, out)
    cells(cfg, "kv2", ("kernel", "auto"), out)
    cells(dataclasses.replace(cfg, num_kv_heads=4), "kv4", ("kernel",), out)
    pipeline(out)
    psum(out)
    seq_decode(out)
    seq_verify(cfg, out)
    data_parallel(cfg, out)
    mamba2_step(out)
    constrain_check(out)
    dist.barrier()
    if rank == 0:
        q.put(out)
    dist.destroy_process_group()


if __name__ == "__main__":
    from repro_torch.launch.mesh import free_port
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    mp.start_processes(run, args=(4, free_port(), q), nprocs=4, join=False,
                       start_method="spawn")
    out = q.get(timeout=290)
    if "error" in out:
        raise SystemExit(out["error"])
    print("RESULT " + json.dumps(out), flush=True)
'''


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The checks' numbers from one 4-rank run."""
    path = tmp_path_factory.mktemp("multirank") / "multirank.py"
    path.write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    p = subprocess.Popen([sys.executable, str(path)], stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, env=env,
                         start_new_session=True)
    try:
        stdout, stderr = p.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        # a rank stuck in a collective: stop the spawn and its ranks
        os.killpg(p.pid, signal.SIGKILL)
        stdout, stderr = p.communicate()
        pytest.fail(f"the 4-rank run passed its {TIMEOUT_S} s limit (a rank "
                    f"skipped a collective?)\n{stdout[-4000:]}"
                    f"{stderr[-8000:]}")
    line = next((ln for ln in stdout.splitlines()
                 if ln.startswith("RESULT ")), None)
    assert line is not None, stdout[-4000:] + stderr[-8000:]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("shape", ["4x1", "1x4"])
def test_elastic_restore_onto_a_new_mesh(results, shape):
    r = results[f"elastic_{shape}"]
    assert r["identical"] and r["placements"] and r["step"] == 1, r
    assert r["rel_err"] <= 1e-5, r


@pytest.mark.parametrize("kv,shape,mode", [
    ("kv2", "1x4", "kernel"), ("kv2", "1x4", "auto"), ("kv2", "2x2", "kernel"),
    ("kv2", "2x2", "auto"), ("kv4", "1x4", "kernel"), ("kv4", "2x2", "kernel")])
def test_serve_cells_on_a_mesh_equal_the_unsharded_path(results, kv, shape,
                                                        mode):
    r = results[f"cell_{kv}_{shape}_{mode}"]
    assert r["prefill_rel"] <= 1e-5 and r["decode_rel"] <= 1e-5, r
    # the cache keeps its sequence over the model axis
    assert "Shard(dim=2)" in r["cache_placements"], r
    # decode attention merges the ranks' keys: nothing of the cache is
    # gathered
    assert not {"attention keys", "attention values"} & set(r["gathers"]), r


@pytest.mark.parametrize("case", [
    f"{kv}_{shape}_{mode}" for kv in ("bf16", "int8")
    for shape in ("1x4", "2x2") for mode in ("kernel", "ref")]
    + ["lse_merge_fp32"])
def test_decode_on_a_sequence_sharded_cache(results, case):
    """Each rank attends over its own keys and the ranks merge their
    softmax statistics (the plain versions: the all-reduced max, sum and
    P . V sums; the kernel: its output and log-sum-exp, here merged from
    the plain version's pairs): within the serve cells' 1e-5 of the
    unsharded call, and the cache never gathered. The row with no key
    comes out exact zeros (the reference mode's plain softmax gives the
    unsharded call's uniform average there, as one process does)."""
    r = results["seq_decode"][case]
    assert r["rel_err"] <= 1e-5, r
    assert r["empty_row_zero"] or case.endswith("_ref"), r
    assert not {"attention keys", "attention values"} & set(r["gathers"]), r


@pytest.mark.parametrize("case", [f"{kv}_{mode}" for kv in ("bf16", "int8")
                                  for mode in ("kernel", "ref")])
def test_verify_on_a_sequence_sharded_cache(results, case):
    """Speculative verify against the cache as the decode cells place it:
    each rank attends over its own keys with its clamped windows and the
    ranks merge (the plain versions: all-reduced max, sum and P . V sums,
    as the kernel's merge does by its log-sum-exp on the card), so the
    logits equal one process within 1e-5 x max|logit| (fp32), and so does
    the written cache (its int8 scales round the K / V that the sharded
    projections sum in another order), with no gather of the cache."""
    r = results[f"seq_verify_{case}"]
    assert r["rel_err"] <= 1e-5, r
    assert r["cache_rel"] <= 1e-5, r
    assert "Shard(dim=2)" in r["cache_placements"], r
    assert not {"attention keys", "attention values"} & set(r["gathers"]), r


def test_mamba2_step_on_a_mesh_equals_one_process(results):
    """Two W3A8 steps of a reduced mamba2 on (2, 2): the backward of its
    local-shard products reduces over sharded letters explicitly, every
    rank issuing the same collectives (no hang), and equals one process
    on the global batch within the data-parallel bound."""
    r = results["mamba2_dp_2x2"]
    assert r["steps"] == 2, r
    assert r["metric_rel"] <= 1e-5 and r["param_rel"] <= 1e-5, r


def test_pipeline_matches_sequential(results):
    r = results["pipeline"]
    assert r["fwd"] <= 1e-4 and r["grad"] <= 1e-4, r


def test_compressed_psum(results):
    r = results["psum"]
    assert r["int_sum_exact"] and r["rel_err"] <= 1e-6, r


@pytest.mark.parametrize("shape", ["4x1", "2x2"])
def test_data_parallel_step_equals_one_process(results, shape):
    """Losses, gnorms and parameters after the AdamW steps. The key bias's
    gradient is zero in exact arithmetic (a softmax ignores a constant
    added to every score of a query), so AdamW's normalised step turns its
    rounding noise into steps of about the lr, whose sign follows the
    noise: under (2, 2) the model axis sums the noise in another order,
    and that leaf alone is held only through the metrics there."""
    r = results[f"dp_{shape}"]
    assert r["steps"] == r["want_steps"], r
    assert r["metric_rel"] <= 1e-5 and r["param_rel"] <= 1e-5, r
    if shape == "4x1":
        assert r["key_bias_rel"] <= 1e-5, r


def test_constrain_redistributes_dtensors(results):
    r = results["constrain"]
    assert r["4x6x8"] == ["Shard(dim=0)", "Shard(dim=2)"], r
    assert r["3x6x8"] == ["Replicate()", "Shard(dim=2)"], r     # 3 % 2
    assert r["4x6x5"] == ["Shard(dim=0)", "Replicate()"], r     # 5 % 2
