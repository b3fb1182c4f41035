"""The port's ServingEngine against the JAX ServingEngine on the CPU:
reduced qwen2-1.5b, fp32, the 3-bit policy without activation quant, the
``qp`` form and the ``q`` form (int8 levels, qmatmul's n_lanes on the
card), T = 0, staggered mixed-length admission — token-identical output
and equal decode/prefill call counts. Also the bucketed-admission
invariant and the submit() reason codes."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import quant_dense as jqd
from repro.core.precision import W3A8 as JW3A8
from repro.models import get_model as jget_model
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.engine import generate as jgenerate

from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.core.precision import W3A8
from repro_torch.serving.engine import (FaultPlan, ServingEngine,
                                        SubmitRejected, generate)

JW3 = dataclasses.replace(JW3A8, act_bits=None)
W3 = dataclasses.replace(W3A8, act_bits=None)

# heterogeneous lengths spanning two buckets (<= 8 and 9..16)
PROMPTS = [
    [1, 2, 3],
    [7, 8, 9, 10, 11],
    [20, 21, 22, 23, 24, 25, 26, 27, 28],
    [30, 31, 32, 33],
    [40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51],
]


@pytest.fixture(scope="module")
def qp_models():
    jcfg = jreduced(jget_config("qwen2-1.5b"))
    cfg = reduced(get_config("qwen2-1.5b"))
    jp = jqd.export_container(jget_model(jcfg).init(jax.random.PRNGKey(0),
                                                    jcfg), JW3)
    return jcfg, cfg, jp, bridge.to_torch(jax.device_get(jp))


@pytest.fixture(scope="module")
def q_models():
    jcfg = jreduced(jget_config("qwen2-1.5b"))
    cfg = reduced(get_config("qwen2-1.5b"))
    jp = jqd.export_levels(jget_model(jcfg).init(jax.random.PRNGKey(0),
                                                 jcfg), JW3)
    return jcfg, cfg, jp, bridge.to_torch(jax.device_get(jp))


def _staggered(eng, max_new=5):
    uid_to_prompt = {}
    for p in PROMPTS[:3]:                        # first wave fills all slots
        uid_to_prompt[int(eng.submit(p, max_new=max_new))] = tuple(p)
    eng.step(); eng.step()                       # decode in flight...
    for p in PROMPTS[3:]:                        # ...second wave queues up
        uid_to_prompt[int(eng.submit(p, max_new=max_new))] = tuple(p)
    done = eng.run_all()
    return {uid_to_prompt[r.uid]: list(r.out) for r in done}


@pytest.mark.parametrize("kv_bits", [None, 8])
def test_engine_token_identical_to_jax(qp_models, kv_bits):
    jcfg, cfg, jp, tp = qp_models
    jeng = JServingEngine(jp, jcfg, policy=JW3, slots=3, max_len=32,
                          dtype=jnp.float32, kv_bits=kv_bits)
    eng = ServingEngine(tp, cfg, policy=W3, slots=3, max_len=32,
                        dtype=torch.float32, kv_bits=kv_bits, device="cpu")
    ref, got = _staggered(jeng), _staggered(eng)
    assert got == ref and len(got) == len(PROMPTS)
    assert all(len(v) == 5 for v in got.values())
    assert eng.decode_calls == jeng.decode_calls
    assert eng.prefill_calls == jeng.prefill_calls


@pytest.mark.parametrize("kv_bits", [None, 8])
def test_q_form_engine_token_identical_to_jax(q_models, kv_bits):
    """The ``q`` serve form (export_levels: int8 levels at full shape, every
    projection through qmatmul) served by both engines from the same
    weights: the same tokens and the same decode and prefill calls."""
    jcfg, cfg, jp, tp = q_models
    assert "q" in tp["layers"]["attn"]["wq"] and "qp" not in \
        tp["layers"]["attn"]["wq"]
    jeng = JServingEngine(jp, jcfg, policy=JW3, slots=3, max_len=32,
                          dtype=jnp.float32, kv_bits=kv_bits)
    eng = ServingEngine(tp, cfg, policy=W3, slots=3, max_len=32,
                        dtype=torch.float32, kv_bits=kv_bits, device="cpu")
    ref, got = _staggered(jeng), _staggered(eng)
    assert got == ref and len(got) == len(PROMPTS)
    assert all(len(v) == 5 for v in got.values())
    assert eng.decode_calls == jeng.decode_calls
    assert eng.prefill_calls == jeng.prefill_calls


def test_kernel_dispatch_engine_matches_plain(qp_models):
    """matmul_mode/attn_mode 'kernel' (the ops wrappers; plain versions on
    CPU tensors) serve the same tokens as the plain dequant/ref paths."""
    _, cfg, _, tp = qp_models
    outs = []
    for mm, am in (("dequant", "ref"), ("kernel", "kernel")):
        eng = ServingEngine(tp, cfg, policy=W3, slots=3, max_len=32,
                            dtype=torch.float32, matmul_mode=mm,
                            attn_mode=am, device="cpu")
        outs.append(_staggered(eng))
    assert outs[0] == outs[1]


def test_profile_phase_timers(qp_models):
    """``profile=True`` keeps the reference's phase timers: the same tokens
    as ``profile=False`` and as the JAX engine's ``profile=True``;
    ``prefill_secs`` grows with an admission and ``decode_secs`` with a
    tick, both 0.0 with profiling off; a degradation-ladder step (spec ->
    plain, after an injected tick failure) keeps them running."""
    jcfg, cfg, jp, tp = qp_models
    kw = dict(slots=3, max_len=32, kv_bits=None)
    jeng = JServingEngine(jp, jcfg, policy=JW3, dtype=jnp.float32,
                          profile=True, **kw)
    off = ServingEngine(tp, cfg, policy=W3, dtype=torch.float32,
                        device="cpu", **kw)
    eng = ServingEngine(tp, cfg, policy=W3, dtype=torch.float32,
                        profile=True, device="cpu", **kw)
    eng.submit(PROMPTS[0], max_new=5)
    eng._spin_up()
    assert eng.prefill_secs > 0 and eng.decode_secs == 0.0
    eng.run_all()
    assert eng.decode_secs > 0
    ref, got = _staggered(jeng), _staggered(off)
    eng = ServingEngine(tp, cfg, policy=W3, dtype=torch.float32,
                        profile=True, device="cpu", **kw)
    assert _staggered(eng) == got == ref
    assert (off.prefill_secs, off.decode_secs) == (0.0, 0.0)
    assert jeng.prefill_secs > 0 and jeng.decode_secs > 0
    spec = ServingEngine(tp, cfg, policy=W3, dtype=torch.float32,
                         profile=True, spec_k=2,
                         fault_plan=FaultPlan(fail_ticks=[1]), device="cpu",
                         **kw)
    spec.submit(PROMPTS[1], max_new=8)
    while not spec.fallback_events:
        spec.step()
    assert spec.spec_k == 0
    secs = (spec.prefill_secs, spec.decode_secs)
    spec.submit(PROMPTS[0], max_new=4)
    spec.run_all()
    assert spec.prefill_secs > secs[0] and spec.decode_secs > secs[1]


def test_generate_matches_jax(qp_models):
    jcfg, cfg, jp, tp = qp_models
    prompts = np.array([[5, 6, 7, 8], [9, 1, 2, 3]], np.int32)
    ref = jgenerate(jp, jnp.asarray(prompts), jcfg, policy=JW3,
                    max_new_tokens=6, dtype=jnp.float32)
    got = generate(tp, prompts, cfg, policy=W3, max_new_tokens=6,
                   dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_same_bucket_admission_is_one_prefill(qp_models):
    _, cfg, _, tp = qp_models
    eng = ServingEngine(tp, cfg, policy=W3, slots=4, max_len=32,
                        dtype=torch.float32, device="cpu")
    for ln in (3, 4, 5, 6):                      # all in the <= 8 bucket
        eng.submit(list(range(1, ln + 1)), max_new=3)
    eng.step()
    assert eng.prefill_calls == 1 and eng.decode_calls == 1
    eng.run_all()
    eng.submit([9, 9, 9], max_new=3)             # a later same-bucket wave
    eng.submit([5, 5], max_new=3)
    eng.step()
    assert eng.prefill_calls == 2
    done = eng.run_all()
    assert sorted(len(r.out) for r in done) == [3, 3]


def test_eos_frees_slot_early(qp_models):
    _, cfg, _, tp = qp_models
    eng = ServingEngine(tp, cfg, policy=W3, slots=2, max_len=32,
                        dtype=torch.float32, device="cpu")
    eng.submit([1, 2, 3], max_new=6)
    first = eng.run_all()[0].out
    eng = ServingEngine(tp, cfg, policy=W3, slots=2, max_len=32,
                        dtype=torch.float32, eos_id=first[2], device="cpu")
    eng.submit([1, 2, 3], max_new=6)
    assert eng.run_all()[0].out == first[:first.index(first[2]) + 1]


@pytest.mark.parametrize("prompt,max_new,reason", [
    ([], 4, "empty_prompt"), ([1, 2], 0, "bad_max_new"),
    ([1] * 30, 3, "too_long")])
def test_submit_reason_codes(qp_models, prompt, max_new, reason):
    _, cfg, _, tp = qp_models
    eng = ServingEngine(tp, cfg, policy=W3, slots=2, max_len=32,
                        dtype=torch.float32, device="cpu")
    with pytest.raises(SubmitRejected) as ei:
        eng.submit(prompt, max_new=max_new)
    assert ei.value.reason == reason and isinstance(ei.value, ValueError)
    ok = eng.submit([1, 2], max_new=2)
    assert ok.accepted and ok.uid == 1 and int(ok) == 1


def test_cuda_device_without_card_raises(qp_models):
    """No silent move to the CPU: asking for the card where there is none
    fails."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, cfg, _, tp = qp_models
    with pytest.raises((RuntimeError, AssertionError)):
        ServingEngine(tp, cfg, policy=W3, slots=2, max_len=32)


def test_serve_cli_runs_on_cpu(capsys):
    """The launcher, asked for the CPU, initialises from a seeded generator,
    exports W3A8 containers and serves mixed-length requests."""
    from repro_torch.launch import serve
    serve.main(["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
                "--requests", "5", "--slots", "2", "--max-new", "4",
                "--kv8"])
    out = capsys.readouterr().out
    assert "5 requests, 20 tokens" in out and "on cpu" in out
