"""The port's contract linter (``repro_torch.analysis``) and its kernel ops.

Every pass fires on a deliberately broken function and names the op; the
registry sweep (4 families x 2 forms x 2 modes, fake ``"cuda"`` tensors)
is clean; at every kernel-mode contract point the port's kernel ops equal,
kernel by kernel, the ``pallas_call`` eqns of the reference's
``jax.make_jaxpr`` of the same point (a scan body counted once per
iteration); the forbidden dequant shapes and ``DTYPE_BYTES`` agree with
the reference's; the cost and memory summaries are exact on known ops;
the collective bytes of a known redistribute on a fake (4, 4) mesh are
exact. Nothing here executes a kernel or an XLA computation.
"""
import dataclasses
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.analysis import contracts, costs, passes, smem
from repro_torch.analysis.trace import (fake_mode, fake_tree,
                                        find_kernel_ops, op_label, trace)
from repro_torch.kernels import _ops
from repro_torch.kernels.attn_decode import ops as dec_ops
from repro_torch.kernels.attn_prefill import ops as pf_ops
from repro_torch.kernels.qmatmul import ops as qmm_ops
from repro_torch.kernels.qmatvec import ops as qmv_ops

ROOT = pathlib.Path(__file__).resolve().parents[1]
CUDA = torch.device("cuda", 0)
# the reference's kernel directory -> the port's registered op
KERNEL_OF = {"qmatvec": "qmatvec", "qmatmul": "qmatmul",
             "attn_decode": "attn_decode", "attn_prefill": "attn_prefill",
             "sigmoid_pw": "sigmoid_pw"}


def _fake(*shapes, dtype=torch.float32, mode=None):
    mode = mode or fake_mode()
    with mode:
        out = [torch.empty(s, dtype=dtype, device=CUDA) for s in shapes]
    return out if len(out) > 1 else out[0]


# --- the kernels as registered ops --------------------------------------------------

def test_every_kernel_is_a_registered_op():
    assert set(_ops.OP_NAMES) == {"qmatvec", "qmatmul", "attn_decode",
                                  "attn_prefill", "sigmoid_pw",
                                  "sigmoid_pw_bwd"}
    for name in _ops.OP_NAMES:
        assert getattr(torch.ops.repro_torch, name).default


def test_a_real_cpu_tensor_reaching_a_kernel_op_is_a_dispatcher_error():
    x = torch.zeros((2, 20))
    with pytest.raises(NotImplementedError, match="CPU"):
        torch.ops.repro_torch.qmatvec(x, torch.zeros((2, 4), dtype=torch.int32),
                                      torch.ones(4), None, torch.float32)
    with pytest.raises(NotImplementedError, match="CPU"):
        torch.ops.repro_torch.sigmoid_pw(torch.zeros(4))


def test_fake_ops_allocate_what_the_launch_allocates_and_note_its_plan():
    """Under fake tensors each kernel op returns the launch's output (shape,
    dtype, device, strides), notes its plan and scratch, and launches
    nothing (the launch counters stay)."""
    from repro_torch.kernels.attn_decode import kernel as dec_k
    from repro_torch.kernels.qmatvec import kernel as qmv_k
    fm = fake_mode()
    before = (qmv_k.launches, dec_k.launches)
    with fm, _ops.recording() as notes:
        x = torch.empty((8, 1536), dtype=torch.bfloat16, device=CUDA)
        w = torch.empty((154, 8960), dtype=torch.int32, device=CUDA)
        d = torch.empty((8960,), device=CUDA)
        y = qmv_ops.qmatvec(x, w, d, k=1536)
        q = torch.empty((8, 1, 12, 128), dtype=torch.bfloat16, device=CUDA)
        kc = torch.empty((8, 4096, 2, 128), dtype=torch.bfloat16, device=CUDA)
        o = dec_ops.attn_decode(q, kc, kc, torch.empty(
            (8,), dtype=torch.int32, device=CUDA))
    assert (qmv_k.launches, dec_k.launches) == before
    assert (tuple(y.shape), y.dtype, y.device, y.stride()) == (
        (8, 8960), torch.bfloat16, CUDA, (8960, 1))
    assert (tuple(o.shape), o.dtype) == ((8, 1, 12, 128), torch.bfloat16)
    p = qmv_k.plan(8, 1536, 8960, torch.bfloat16)
    assert notes[0]["kernel"] == "qmatvec" and notes[0]["plan"] == p
    assert notes[0]["variant"] == "decode"
    assert notes[0]["dynamic_smem"] == p.dynamic_smem
    dp = dec_k.plan(8, 4096, 2, 6, 128, torch.bfloat16)
    assert notes[1]["scratch"] == [((8 * 2 * dp.splits * 6 * 130,),
                                    torch.float32)]
    assert notes[1]["grid"] == (dp.splits, 16)


# --- one true positive per check ----------------------------------------------------

def test_no_dequant_fires_on_a_dequantized_matmul():
    fm = fake_mode()
    x = _fake((8, 64), mode=fm)
    with fm:
        lv = torch.empty((64, 96), dtype=torch.int8, device=CUDA)
        delta = torch.empty((96,), device=CUDA)
    tr = trace(lambda: x @ (lv.float() * delta), mode=fm)
    viols = passes.check_no_dequant(tr, {(64, 96)})
    assert viols and all(v.check == "no_dequant" for v in viols)
    hit = next(v for v in viols if v.eqn)
    assert "(64, 96)" in hit.message and "aten._to_copy" in hit.eqn
    assert any("no repro_torch kernel op" in v.message for v in viols)
    # the kernel path holds it
    with fm:
        w = torch.empty((64, 96), dtype=torch.int8, device=CUDA)
    tr = trace(lambda: qmm_ops.qmatmul(x, w, delta), mode=fm)
    assert not passes.check_no_dequant(tr, {(64, 96)})


def test_no_quadratic_scores_fires_on_a_plain_attention_prefill():
    fm = fake_mode()
    q, k = _fake((2, 4, 48, 16), (2, 4, 48, 16), mode=fm)
    tr = trace(lambda: torch.softmax(q @ k.transpose(-1, -2), -1), mode=fm)
    viols = passes.check_no_quadratic_scores(tr, 48, 48)
    assert viols and viols[0].check == "no_quadratic_scores"
    assert "(2, 4, 48, 48)" in viols[0].message
    assert viols[0].eqn.startswith("aten.")
    with fm:
        hi = torch.empty((2, 48), dtype=torch.int32, device=CUDA)
        qq = torch.empty((2, 48, 4, 16), device=CUDA)
        kv = torch.empty((2, 48, 2, 16), device=CUDA)
    tr = trace(lambda: pf_ops.attn_prefill(qq, kv, kv, hi), mode=fm)
    assert not passes.check_no_quadratic_scores(tr, 48, 48,
                                                require_kernel=True)


@pytest.mark.parametrize("case", ["item", "cpu", "nonzero", "synchronize"])
def test_no_host_callback_fires_on_each_host_sync(case):
    fm = fake_mode()
    x = _fake((4, 8), mode=fm)
    fns = {"item": lambda: x.sum().item(),
           "cpu": lambda: x.cpu(),
           "nonzero": lambda: torch.nonzero(x > 0),
           "synchronize": lambda: torch.cuda.synchronize()}
    tr = trace(fns[case], mode=fm)
    viols = passes.check_no_host_callback(tr)
    assert len(viols) == 1 and viols[0].check == "no_host_callback"
    want = {"item": "_local_scalar_dense", "cpu": "_to_copy",
            "nonzero": "nonzero", "synchronize": "synchronize"}[case]
    assert want in viols[0].message + viols[0].eqn


def _fake_engine(family="dense", form="qp", spec=False):
    return contracts._engine(family, form, "kernel", spec=spec, device=CUDA)


def _point(eng, fm, name):
    with fm:
        return next(p for p in eng.contract_points() if p["name"] == name)


def test_carry_dtype_fires_when_the_tick_replaces_a_carried_buffer():
    eng, fm = _fake_engine()
    p = _point(eng, fm, "decode_tick")
    real = eng._tick

    def drifting():
        real()
        eng._emitted = eng._emitted.to(torch.int64)      # the drift
        eng._tokens = eng._tokens.clone()                # a new tensor
    tr = trace(drifting, inputs=p["inputs"], carry=p["carry"], mode=fm)
    viols = passes.check_carry_fixed_point(tr, point="decode_tick")
    msgs = " | ".join(v.message for v in viols)
    assert len(viols) == 2 and all(v.check == "carry_dtype" for v in viols)
    assert "emitted" in msgs and "int32[2]" in msgs and "int64[2]" in msgs
    assert "tokens" in msgs and "new tensor" in msgs
    tr = trace(p["fn"], inputs=p["inputs"], carry=p["carry"], mode=fm)
    assert not passes.check_carry_fixed_point(tr, point="decode_tick")


def test_scan_carries_flags_a_reintroduced_block_decode_drift(monkeypatch):
    """Reintroduce an old bug: ``mamba2.block_decode`` returning the conv
    tail in bf16 instead of the carried state's fp32. The tick writes it
    into the carried conv state in place — a silent cast the pass names."""
    from repro_torch.core.precision import FLOAT
    from repro_torch.models import mamba2
    from repro_torch.serving.engine import ServingEngine
    cfg = contracts.family_config("ssm")
    params = mamba2.init(torch.Generator().manual_seed(0), cfg)
    fm = fake_mode()
    params = fake_tree(params, fm, CUDA)
    with fm:
        eng = ServingEngine(params, cfg, policy=FLOAT, slots=2, max_len=32,
                            dtype=torch.float32, capture=False, device=CUDA)
    p = _point(eng, fm, "decode_tick")
    tr = trace(p["fn"], inputs=p["inputs"], carry=p["carry"], mode=fm)
    assert not passes.check_scan_carries(tr)
    real = mamba2.block_decode

    def drifting(lp, h_in, state, cfg, **kw):
        h, st = real(lp, h_in, state, cfg, **kw)
        return h, dict(st, conv=st["conv"].to(torch.bfloat16))

    monkeypatch.setattr(mamba2, "block_decode", drifting)
    tr = trace(p["fn"], inputs=p["inputs"], carry=p["carry"], mode=fm)
    viols = passes.check_scan_carries(tr)
    assert viols and all(v.check == "carry_dtype" for v in viols)
    assert any("bfloat16" in v.message and "float32" in v.message
               and v.eqn.startswith("aten.copy_") for v in viols)


def test_donation_fires_when_the_cache_is_copied_whole():
    eng, fm = _fake_engine()
    p = _point(eng, fm, "decode_tick")
    real = eng._tick

    def copying():
        eng.cache = {k: v.clone() for k, v in eng.cache.items()}
        real()
    tr = trace(copying, inputs=p["inputs"], carry=p["carry"], mode=fm)
    viols = passes.check_donation(tr, p["donate"], point="decode_tick")
    assert viols and all(v.check == "donation" for v in viols)
    assert any("copied whole" in v.message and v.eqn.startswith(
        "aten.clone") for v in viols)
    assert any("not the same tensor" in v.message for v in viols)
    tr = trace(p["fn"], inputs=p["inputs"], carry=p["carry"], mode=fm)
    assert not passes.check_donation(tr, p["donate"], point="decode_tick")


def test_smem_budget_fires_on_a_launch_over_the_budget():
    fm = fake_mode()
    with fm:
        q = torch.empty((8, 256, 12, 128), dtype=torch.bfloat16, device=CUDA)
        kv = torch.empty((8, 256, 2, 128), dtype=torch.bfloat16, device=CUDA)
        hi = torch.empty((8, 256), dtype=torch.int32, device=CUDA)
    tr = trace(lambda: pf_ops.attn_prefill(q, kv, kv, hi), mode=fm)
    est = smem.kernel_smem_estimate(find_kernel_ops(tr)[0])
    assert est["function"] == "attn_prefill_kernel_wgmma"
    assert est["static_bytes"] == 128 and est["dynamic_bytes"] == 81920
    assert est["blocks_per_sm"] == (228 * 1024) // (81920 + 128 + 1024)
    assert not passes.check_smem_budget(tr)
    viols = passes.check_smem_budget(tr, budget_bytes=64 * 1024)
    assert len(viols) == 1 and viols[0].check == "smem_budget"
    assert "82048" in viols[0].message
    assert viols[0].eqn.startswith("repro_torch.attn_prefill.default[wgmma]")


def test_ptxas_entries_read_registers_spills_and_static_smem():
    log = ("ptxas info    : Compiling entry function "
           "'_Z26attn_decode_kernel_combineIfLi128EEvPKfS1_S1_PT_ii' for "
           "'sm_90a'\nptxas info    : Function properties for x\n"
           "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
           "loads\nptxas info    : Used 40 registers, 4112 bytes smem, 400 "
           "bytes cmem[0]\n")
    (e,) = smem.ptxas_entries(log)
    assert (e["function"], e["registers"], e["spill"], e["smem"]) == (
        "attn_decode_kernel_combine", 40, (8, 4), 4112)
    assert e["smem"] == smem.STATIC_SMEM[e["function"]]


def test_capture_report_budgets():
    class Engine:
        captures = {"tick": 2, "admit": {8: 1, 16: 3}}

    rep = contracts.capture_report(Engine(), {"tick": 1, "admit": 1})
    assert rep["counts"] == {"tick": 2, "admit[8]": 1, "admit[16]": 3}
    assert [v["message"].split("'")[1] for v in rep["violations"]] == [
        "admit[16]", "tick"]


def test_violation_str_carries_the_op():
    v = passes.Violation("no_dequant", "msg", eqn="aten.mm.default -> f[4]")
    assert str(v) == "no_dequant: msg [at: aten.mm.default -> f[4]]"
    assert dataclasses.asdict(v) == v.to_dict()


# --- costs --------------------------------------------------------------------------

def test_cost_and_memory_summaries_are_exact_on_known_ops():
    fm = fake_mode()
    x, w = _fake((8, 16), (16, 4), mode=fm)

    def fn(x, w):
        y = x @ w                    # 2 * 8 * 16 * 4 flops, 128 B
        z = torch.exp(y)             # 32 transcendentals, 128 B
        return z + 1                 # 128 B, returned
    tr = trace(fn, x, w, mode=fm)
    c = costs.cost_summary(tr)
    assert c["flops"] == 2 * 8 * 16 * 4
    assert c["transcendentals"] == 32
    assert c["bytes"] == (512 + 256 + 128) + (128 + 128) + (128 + 128)
    m = costs.memory_summary(tr)
    assert m == {"argument_bytes": 768.0, "output_bytes": 128.0,
                 "temp_bytes": 256.0, "alias_bytes": 0.0,
                 "peak_bytes_est": 768.0 + 256 + 128}
    # an in-place update of an argument is an alias, not a new output
    tr = trace(lambda x: x.mul_(2), x, mode=fm)
    m = costs.memory_summary(tr)
    assert (m["alias_bytes"], m["temp_bytes"], m["peak_bytes_est"]) == (
        512.0, 0.0, 512.0)


def test_kernel_op_flops_and_scratch_count():
    """The kernel ops' formulas (2 M K N, 4 B H T S D) and the scratch a
    launch allocates enter the summaries."""
    fm = fake_mode()
    with fm:
        x = torch.empty((8, 1536), dtype=torch.bfloat16, device=CUDA)
        w = torch.empty((154, 8960), dtype=torch.int32, device=CUDA)
        d = torch.empty((8960,), device=CUDA)
        q = torch.empty((8, 1, 12, 128), dtype=torch.bfloat16, device=CUDA)
        kc = torch.empty((8, 4096, 2, 128), dtype=torch.bfloat16, device=CUDA)
        lens = torch.empty((8,), dtype=torch.int32, device=CUDA)
    tr = trace(lambda: qmv_ops.qmatvec(x, w, d, k=1536), mode=fm)
    assert costs.cost_summary(tr)["flops"] == 2 * 8 * 1536 * 8960
    tr = trace(lambda: dec_ops.attn_decode(q, kc, kc, lens), mode=fm)
    (rec,) = [r for r in tr.ops if r.kernel]
    assert rec.flops == 4 * 8 * 12 * 1 * 4096 * 128
    assert rec.transcendentals == 8 * 12 * 4096
    scratch = sum(np.prod(s) * dt.itemsize for s, dt in rec.kernel["scratch"])
    assert tr.memory["temp_bytes"] >= scratch > 0


def test_dtype_bytes_agree_with_the_reference():
    spec = importlib.util.spec_from_file_location(
        "ref_hlo", ROOT / "src" / "repro" / "analysis" / "hlo.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    names = {torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
             torch.int16: "s16", torch.uint16: "u16", torch.bfloat16: "bf16",
             torch.float16: "f16", torch.int32: "s32", torch.uint32: "u32",
             torch.float32: "f32", torch.int64: "s64", torch.uint64: "u64",
             torch.float64: "f64", torch.complex64: "c64",
             torch.float8_e4m3fn: "f8e4m3fn",
             torch.float8_e4m3fnuz: "f8e4m3fnuz",
             torch.float8_e5m2: "f8e5m2", torch.float8_e5m2fnuz: "f8e5m2fnuz"}
    assert set(costs.DTYPE_BYTES) == set(names)
    for dt, name in names.items():
        assert costs.DTYPE_BYTES[dt] == ref.DTYPE_BYTES[name] == dt.itemsize
    assert costs.KINDS == ref.KINDS


@pytest.fixture
def fake_group():
    import torch.distributed as dist
    from repro_torch.launch.dryrun import fake_world
    fake_world(16)
    yield
    dist.destroy_process_group()


def test_collective_bytes_of_a_known_redistribute(fake_group):
    """A (64, 32) fp32 tensor on a fake (4, 4) mesh, rows over mesh dim 0,
    to columns over mesh dim 1: DTensor takes the rank's column chunk
    locally first, then all-gathers the (16, 8) rows (512 B a rank); a
    Partial sum to Replicate: one all-reduce of the whole (64, 32) (8192
    B)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
    fm = fake_mode()
    with fm:
        a = distribute_tensor(torch.empty((64, 32)), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        p = DTensor.from_local(torch.empty((64, 32)), mesh,
                               [Partial(), Replicate()])
    tr = trace(lambda: a.redistribute(mesh, [Replicate(), Shard(1)]),
               mode=fm)
    assert costs.collective_bytes(tr) == {"all-gather": 512.0,
                                          "total": 512.0, "count": 1}
    tr = trace(lambda: p.redistribute(mesh, [Replicate(), Replicate()]),
               mode=fm)
    assert costs.collective_bytes(tr) == {"all-reduce": 8192.0,
                                          "total": 8192.0, "count": 1}


# --- the registry -------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lint(family, form, mode):
    return contracts.lint_combo(family, form, mode)


COMBOS = [(f, fo, m) for f in contracts.FAMILIES for fo in contracts.FORMS
          for m in contracts.MODES]


@pytest.mark.parametrize("family,form,mode", COMBOS,
                         ids=["/".join(c) for c in COMBOS])
def test_the_sweep_is_clean(family, form, mode):
    """Every contract holds at every point; every kernel-mode point but the
    pure scatter runs kernel ops, every fallback point none and trips its
    signal detectors (their checks are in the record, empty)."""
    recs = _lint(family, form, mode)
    bad = {(r["point"], c): v for r in recs
           for c, v in r["checks"].items() if v}
    assert not bad, bad
    names = {r["point"] for r in recs}
    want = {"decode_tick", "prefill_bucketed", "admit_many", "generate_loop"}
    if family != "ssm":
        want |= {"spec_tick", "verify"}
    assert names == want
    for r in recs:
        if mode == "kernel":
            assert bool(r["kernel_ops"]) == (r["point"] != "admit_many")
            assert all(k["dynamic_bytes"] + k["static_bytes"]
                       <= smem.DEFAULT_SMEM_BUDGET for k in r["kernels"])
        else:
            assert not r["kernel_ops"]
            if r["point"] != "admit_many":
                assert "no_dequant_signal" in r["checks"]


# --- against the reference ----------------------------------------------------------

def _subjaxprs(val):
    if hasattr(val, "jaxpr") and hasattr(val, "consts"):
        yield val.jaxpr
    elif hasattr(val, "eqns"):
        yield val
    elif isinstance(val, (tuple, list)):
        for v in val:
            yield from _subjaxprs(v)


def _pallas_counts(jaxpr, mult=1, out=None):
    """``pallas_call`` eqns of a jaxpr by kernel (the kernel's directory
    under ``repro/kernels``), a scan's body counted ``length`` times; a
    kernel's own body is not descended into."""
    out = {} if out is None else out
    jx = jaxpr.jaxpr if hasattr(jaxpr, "consts") else jaxpr
    for eqn in jx.eqns:
        if eqn.primitive.name == "pallas_call":
            src = eqn.params["jaxpr"].debug_info.func_src_info
            name = KERNEL_OF[src.split("/kernels/")[1].split("/")[0]]
            out[name] = out.get(name, 0) + mult
            continue
        assert eqn.primitive.name not in ("while", "cond"), eqn.primitive
        m = mult * (eqn.params["length"] if eqn.primitive.name == "scan"
                    else 1)
        for v in eqn.params.values():
            for sj in _subjaxprs(v):
                _pallas_counts(sj, m, out)
    return out


def _reference_counts(family, form):
    """{point: pallas_call counts} of the reference's registry points in
    kernel mode (its ``lint_combo``'s points, traced by make_jaxpr)."""
    from repro.configs import get_config, reduced
    from repro.core import quant_dense
    from repro.core.precision import W3A8
    from repro.models import api, get_model
    from repro.serving.engine import ServingEngine, generate
    w3 = dataclasses.replace(W3A8, act_bits=None)
    layers = 4 if family == "hybrid" else 2
    cfg = reduced(get_config(contracts.ARCH_FOR[family]), layers=layers,
                  d_model=32, vocab=64)
    params = get_model(cfg).init(jax.random.PRNGKey(0), cfg)
    sp = (quant_dense.export_levels if form == "q"
          else quant_dense.export_container)(params, w3)
    kw = dict(matmul_mode="kernel", attn_mode="kernel")

    def engine(spec):
        return ServingEngine(sp, cfg, policy=w3, slots=contracts.SLOTS,
                             max_len=contracts.MAX_LEN, dtype=jnp.float32,
                             attn_chunk=contracts.MAX_LEN,
                             spec_k=contracts.SPEC_K if spec else 0, **kw)
    points = engine(False).contract_points()
    if family != "ssm":
        points += [p for p in engine(True).contract_points()
                   if p["name"] == "spec_tick"]
    out = {p["name"]: _pallas_counts(jax.make_jaxpr(p["fn"])(*p["args"]))
           for p in points}
    if family != "ssm":
        t = contracts.SPEC_K + 1
        cache = api.init_cache_abstract(cfg, contracts.SLOTS,
                                        contracts.MAX_LEN, jnp.float32,
                                        per_slot_len=True)
        toks = jax.ShapeDtypeStruct((contracts.SLOTS, t), jnp.int32)
        out["verify"] = _pallas_counts(jax.make_jaxpr(
            lambda c, tk: api.verify_step(sp, c, tk, cfg, policy=w3,
                                          dtype=jnp.float32, **kw))(
                cache, toks))
    prompts = jax.ShapeDtypeStruct((1, 4), jnp.int32)
    out["generate_loop"] = _pallas_counts(jax.make_jaxpr(
        lambda pr: generate(sp, pr, cfg, policy=w3, max_new_tokens=4,
                            dtype=jnp.float32, **kw))(prompts))
    return out


@pytest.mark.parametrize("family,form", [(f, fo) for f in contracts.FAMILIES
                                         for fo in contracts.FORMS])
def test_kernel_ops_equal_the_reference_pallas_calls(family, form):
    ref = _reference_counts(family, form)
    port = {r["point"]: r["kernel_ops"] for r in _lint(family, form,
                                                       "kernel")}
    assert port == ref


@pytest.mark.parametrize("family", contracts.FAMILIES)
def test_forbidden_dequant_shapes_equal_the_reference(family):
    """The port's set on the bridged params equals the reference's, built
    from ``repro.core`` on the JAX params (``repro.analysis`` does not
    import under this jax)."""
    from repro.configs import get_config, reduced
    from repro.core import quant_dense
    from repro.core.precision import W3A8
    from repro.core.treeutil import flatten_with_path, role_of
    from repro.models import get_model
    from repro_torch.bridge import to_torch
    layers = 4 if family == "hybrid" else 2
    cfg = reduced(get_config(contracts.ARCH_FOR[family]), layers=layers,
                  d_model=32, vocab=64)
    params = get_model(cfg).init(jax.random.PRNGKey(0), cfg)
    w3 = dataclasses.replace(W3A8, act_bits=None)
    want = set()
    for path, leaf in flatten_with_path(params).items():
        if not (path.endswith("/w") or path == "w"):
            continue
        if w3.spec_for(role_of(path)) is None:
            continue
        nd = quant_dense._stacked_dims(path)
        want |= {tuple(leaf.shape), tuple(leaf.shape[nd:])}
    got = contracts.forbidden_dequant_shapes(to_torch(params))
    assert got == want and want


def test_op_labels_name_kernel_variants():
    fm = fake_mode()
    with fm:
        x = torch.empty((8, 1536), dtype=torch.bfloat16, device=CUDA)
        w = torch.empty((151936, 1536), dtype=torch.int8, device=CUDA)
    tr = trace(lambda: qmm_ops.qmatmul(x, w.T, 1.0), mode=fm)
    (rec,) = find_kernel_ops(tr)
    assert op_label(rec) == ("repro_torch.qmatmul.default[k_lanes/k_major] "
                             "-> bfloat16[8, 151936]")
