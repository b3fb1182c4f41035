"""The port's dry run (``repro_torch.launch.dryrun``): one reduced cell of
each kind — train, prefill, decode — built by ``launch.steps.build_cell``
on the single-pod 16 x 16 production mesh of a fake process group of 256
ranks (``"cpu"`` mesh, fake tensors: nothing executes), traced, and
recorded with the reference's keys, its reduced-depth aux lowerings
included. The config keeps qwen2-1.5b's structure (GQA 4 / 2 heads, tied
embedding) at d_model 64, d_ff 256, vocab 128, 2 layers, 64 tokens x 32
rows."""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced, shape_by_name
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.analysis import costs

CFG = dataclasses.replace(reduced(get_config("qwen2-1.5b"), layers=2,
                                  d_model=64, vocab=128), d_ff=256)
KEYS = {"arch", "shape", "mesh", "quant", "num_layers", "attn_every",
        "params", "active_params", "seq_len", "global_batch", "kind", "full",
        "status", "aux_scheme"}
SUMMARY = {"cost": {"flops", "bytes", "transcendentals"},
           "memory": {"argument_bytes", "output_bytes", "temp_bytes",
                      "alias_bytes", "peak_bytes_est"}}


TIMEOUT_S = 240      # a cell that runs past this fails, not the suite


@pytest.fixture(scope="module", autouse=True)
def _no_group_left():
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(autouse=True)
def _timeout(request):
    """Each test's own time limit (SIGALRM in the test's thread): a trace
    that hangs fails its test instead of eating the suite's clock."""
    import signal

    def expire(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past {TIMEOUT_S} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, TIMEOUT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _check_lowering(rec):
    for name, keys in SUMMARY.items():
        assert set(rec[name]) == keys, name
    assert rec["memory"]["peak_bytes_est"] >= rec["memory"]["argument_bytes"]
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes"] > 0
    assert {"total", "count"} <= set(rec["collectives"])
    assert rec["collectives"]["count"] > 0       # a 16 x 16 mesh talks
    assert rec["compile_s"] >= 0


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
def test_a_reduced_cell_of_each_kind_on_the_fake_16x16_mesh(shape_name,
                                                              tmp_path):
    shape = dataclasses.replace(shape_by_name(shape_name), seq_len=64,
                                global_batch=32)
    rec = dryrun.run_cell("qwen2-1.5b", shape_name, "single", "w3",
                          force=True, device="cpu", cfg=CFG, shape=shape,
                          out_dir=tmp_path)
    assert rec["status"] == "ok", rec.get("traceback")
    aux = {"L0", "L1"}
    if shape.kind == "prefill":
        samples = dryrun.prefill_seq_samples(CFG)
        assert rec["aux_scheme"] == "seqfit" and rec["seq_samples"] == samples
        aux = {f"{n}@{s}" for n in ("L0", "L1") for s in samples}
        assert set(rec) == KEYS | aux | {"seq_samples", "device"}
    else:
        assert rec["aux_scheme"] == "exact"
        assert set(rec) == KEYS | aux | {"device"}
    assert (rec["kind"], rec["mesh"], rec["num_layers"]) == (
        shape.kind, "single", 2)
    for name in aux | {"full"}:
        _check_lowering(rec[name])
    # a trace counts every layer: the full depth costs more than one layer,
    # one layer more than none
    flops = [rec[k]["cost"]["flops"] for k in (
        ("L0@1024", "L1@1024") if shape.kind == "prefill" else ("L0", "L1"))]
    assert flops[0] < flops[1]
    if shape.kind != "prefill":
        assert flops[1] < rec["full"]["cost"]["flops"]
    assert (tmp_path / f"{dryrun.cell_id('qwen2-1.5b', shape_name, 'single', 'w3')}.json").exists()


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_the_other_families_decode_cells_on_the_host_mesh(arch, tmp_path):
    """The ssm, hybrid and MoE decode cells build and trace on the (1, 1)
    mesh of a fake one-rank group (the ssm cell once passed ``attn_mode``
    to a model without attention)."""
    cfg = reduced(get_config(arch), layers=4 if arch.startswith("zamba")
                  else 2, d_model=64, vocab=128)
    rec = dryrun.run_cell(arch, "decode_32k", "host", "w3", force=True,
                          device="cpu", cfg=cfg, out_dir=tmp_path,
                          shape=dataclasses.replace(
                              shape_by_name("decode_32k"), seq_len=32,
                              global_batch=4))
    assert rec["status"] == "ok", rec.get("traceback")
    assert "aux_scheme" not in rec          # aux lowerings: single pod only
    assert rec["full"]["collectives"] == {"total": 0, "count": 0}
    assert rec["full"]["cost"]["flops"] > 0


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_the_other_families_train_cells_on_the_fake_16x16_mesh(arch,
                                                               tmp_path):
    """The ssm, hybrid and MoE train cells trace on the 16 x 16 mesh,
    backward included: the SSD core, the mamba2 projections and the MoE
    experts and dispatch run as local-shard products (``shards.einsum``,
    whose backward reduces over the sharded letters explicitly), where
    DTensor's own ``mm`` / ``bmm`` refused a strided sharding; and a
    global batch of fewer token groups (4) than data ranks (16) is
    grouped after a gather, as XLA reshards it."""
    cfg = reduced(get_config(arch), layers=4 if arch.startswith("zamba")
                  else 2, d_model=64, vocab=128)
    rec = dryrun.run_cell(arch, "train_4k", "single", "w3", force=True,
                          device="cpu", cfg=cfg, out_dir=tmp_path,
                          with_aux=False,
                          shape=dataclasses.replace(
                              shape_by_name("train_4k"), seq_len=64,
                              global_batch=32))
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["full"]["collectives"]["count"] > 0
    assert rec["full"]["cost"]["flops"] > 0


def test_decode_keeps_the_cache_where_it_is_placed(tmp_path):
    """A reduced decode_32k cell (batch over data, sequence over model):
    attention runs on each rank's keys and merges the ranks by
    log-sum-exp, so nothing of the cache's batch or sequence is gathered
    (the only gathers: one token's K/V for the cache write, and a
    projection's activation)."""
    rec = dryrun.run_cell("qwen2-1.5b", "decode_32k", "single", "w3",
                          force=True, device="cpu", cfg=CFG,
                          shape=dataclasses.replace(
                              shape_by_name("decode_32k"), seq_len=256,
                              global_batch=32),
                          out_dir=tmp_path, with_aux=False)
    assert rec["status"] == "ok", rec.get("traceback")
    gathers = rec["full"]["gathers"]
    assert gathers and not {"attention keys", "attention values",
                            "per-row operand"} & set(gathers), gathers
    assert rec["full"]["collectives"]["all-reduce"] > 0    # the merge


def test_verify_keeps_the_cache_where_it_is_placed(tmp_path):
    """A speculative verify (spec_k 4: 5 tokens a row) against decode_32k's
    cache at its own length and batch (32768 x 128 on 16 x 16, the reduced
    config's layers): each rank attends over its own keys and the ranks
    merge, so no key or value is gathered, and a rank's peak stays of the
    decode cell's order, below what one layer's gathered K/V alone would
    take (the parent gathered the whole key sequence of every row)."""
    shape = shape_by_name("decode_32k")
    recs = {vt: dryrun.run_cell("qwen2-1.5b", "decode_32k", "single", "w3",
                                force=True, device="cpu", cfg=CFG,
                                out_dir=tmp_path, with_aux=False,
                                verify_tokens=vt) for vt in (0, 5)}
    for rec in recs.values():
        assert rec["status"] == "ok", rec.get("traceback")
    ver = recs[5]["full"]
    assert recs[5]["shape"] == "decode_32k_verify5"
    assert not {"attention keys", "attention values",
                "per-row operand"} & set(ver["gathers"]), ver["gathers"]
    assert ver["collectives"]["all-reduce"] > 0              # the merge
    peak = ver["memory"]["peak_bytes_est"]
    assert peak <= 2 * recs[0]["full"]["memory"]["peak_bytes_est"]
    rows = shape.global_batch // 16                     # a data rank's rows
    gathered_kv = 2 * rows * shape.seq_len * CFG.num_kv_heads \
        * CFG.head_dim * 2                              # one layer, bf16
    assert peak < gathered_kv, (peak, gathered_kv)


def test_a_failing_cell_is_recorded_not_raised(tmp_path):
    """A cell that does not build records its error and traceback."""
    bad = dataclasses.replace(CFG, num_heads=3)       # 64 % 3: no head_dim
    rec = dryrun.run_cell("qwen2-1.5b", "decode_32k", "single", "w3",
                          force=True, device="cpu", cfg=bad,
                          shape=dataclasses.replace(
                              shape_by_name("decode_32k"), seq_len=64,
                              global_batch=32),
                          out_dir=tmp_path, with_aux=False)
    assert rec["status"] == "error" and rec["error"] and rec["traceback"]


def test_hlo_analysis_is_the_costs_module():
    for name in ("collective_bytes", "DTYPE_BYTES", "cost_summary",
                 "memory_summary", "KINDS"):
        assert getattr(hlo_analysis, name) is getattr(costs, name)


@pytest.mark.parametrize("name,kind", [
    ("_c10d_functional.all_gather_into_tensor.default", "all-gather"),
    ("_c10d_functional.all_reduce.default", "all-reduce"),
    ("_c10d_functional.reduce_scatter_tensor.default", "reduce-scatter"),
    ("_c10d_functional.all_to_all_single.default", "all-to-all"),
    ("_c10d_functional.wait_tensor.default", None),
    ("aten.mm.default", None)])
def test_collective_kinds(name, kind):
    assert costs.collective_kind(name) == kind


def test_runnable_shapes_skip_long_context_for_full_attention():
    names = [s.name for s in dryrun.runnable_shapes(get_config("qwen2-1.5b"))]
    assert names == ["train_4k", "prefill_32k", "decode_32k"]
    assert "long_500k" in [s.name for s in dryrun.runnable_shapes(
        get_config("mamba2-2.7b"))]
    assert torch.distributed.is_available()
