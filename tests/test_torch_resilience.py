"""The port's overload hardening against the JAX engine's on the CPU, at
``reduced(qwen2-1.5b)`` (2 layers, d_model 64, vocab 128), fp32,
``act_bits=None``, T = 0, from JAX-initialised weights bridged as numpy:
the float master (FLOAT policy) and its W3 container export (``qp``), with
spec_k = 2 the bridged ``draft_of`` export drafting.

Each case mirrors one of ``tests/test_resilience.py`` and drives both
engines with the same submits, the same ``FaultPlan`` and the same steps:
bounded admission (reject / drop_oldest), deadlines (mid-stream and in the
queue), preemption and requeue, every ladder step, admission delays, the
watchdog and a seeded chaos run. Tolerance: none — the submit outcomes
(uid, reason, shed uids), every request's status, tokens, preemptions and
ticks, every counter, ``fallback_events`` and the watchdog's diagnostics
must be identical."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import quant_dense as jquant_dense
from repro.core.precision import FLOAT as JFLOAT, W3A8 as JW3A8
from repro.models import api as japi
from repro.models import get_model as jget_model
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.resilience import FaultPlan as JFaultPlan
from repro.serving.resilience import WatchdogExpired as JWatchdogExpired

from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.core.precision import FLOAT, W3A8
from repro_torch.serving.engine import ServingEngine, generate
from repro_torch.serving.resilience import (STATUS, FaultPlan,
                                            SubmitRejected, WatchdogExpired)

PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11],
           [20, 21, 22, 23, 24, 25, 26, 27, 28], [30, 31, 32, 33]]
COUNTERS = ("decode_calls", "prefill_calls", "shed_count",
            "deadline_miss_count", "preempt_count", "poisoned_count",
            "queue_peak", "spec_drafted", "spec_accepted", "fallback_events")


@pytest.fixture(scope="module")
def models():
    """{"cfg": (jcfg, cfg), form: (JAX params, port params, JAX policy,
    port policy), "draft": (JAX drafter, port drafter)}."""
    jcfg = jreduced(jget_config("qwen2-1.5b"))
    cfg = reduced(get_config("qwen2-1.5b"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jw3 = dataclasses.replace(JW3A8, act_bits=None)
    w3 = dataclasses.replace(W3A8, act_bits=None)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    jqp = jquant_dense.export_container(jp, jw3)
    _, jdp = japi.draft_of(jcfg, jp)
    host = lambda t: bridge.to_torch(jax.device_get(t))      # noqa: E731
    return {"cfg": (jcfg, cfg), "w": (jp, host(jp), JFLOAT, FLOAT),
            "qp": (jqp, host(jqp), jw3, w3), "draft": (jdp, host(jdp))}


def pair(models, form="w", plan=None, **kw):
    """The JAX engine and the port's, same weights and knobs, fp32."""
    (jcfg, cfg), (jp, tp, jpol, pol) = models["cfg"], models[form]
    kw = dict(dict(slots=2, max_len=32), **kw)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("spec_k"):
        jdp, dp = models["draft"]
        jkw.update(draft_params=jdp, draft_cfg=jcfg)
        tkw.update(draft_params=dp, draft_cfg=cfg)
    if plan is not None:
        jkw["fault_plan"], tkw["fault_plan"] = (JFaultPlan(**plan),
                                                FaultPlan(**plan))
    return (JServingEngine(jp, jcfg, policy=jpol, dtype=jnp.float32, **jkw),
            ServingEngine(tp, cfg, policy=pol, dtype=torch.float32,
                          device="cpu", **tkw))


def outcome(o):
    return (bool(o), o.uid, o.reason, o.shed)


def record(eng, done):
    """Everything the two engines must agree on after a run."""
    return {"requests": sorted((r.uid, r.status, list(r.out), r.preemptions,
                                r.ticks, r.done) for r in done),
            **{k: getattr(eng, k) for k in COUNTERS}}


def run_both(models, submits, *, form="w", plan=None, run=None, **kw):
    """Submit ``submits`` [(prompt, max_new, deadline_ticks)] to both
    engines, drive each with ``run`` (default ``run_all``), and return
    (JAX record, port record, JAX engine, port engine)."""
    jeng, eng = pair(models, form, plan, **kw)
    out = []
    for e in (jeng, eng):
        outs = [outcome(e.submit(list(p), max_new=m, deadline_ticks=d))
                for p, m, d in submits]
        done = (run or (lambda e: e.run_all()))(e)
        out.append(dict(record(e, done), outcomes=outs))
    return out[0], out[1], jeng, eng


def test_submit_rejected_reason_codes(models):
    """Every malformed submit is a SubmitRejected (a ValueError) with the
    reference's reason code; nothing is half-enqueued, and the engine then
    serves as the reference does."""
    jeng, eng = pair(models, max_len=16)
    cases = [(dict(prompt=[], max_new=4), "empty_prompt"),
             (dict(prompt=[1, 2], max_new=0), "bad_max_new"),
             (dict(prompt=list(range(1, 20)), max_new=4), "too_long"),
             (dict(prompt=[1, 2], max_new=4, deadline_ticks=0),
              "bad_deadline")]
    for kw, reason in cases:
        reasons = []
        for e in (jeng, eng):
            with pytest.raises(ValueError) as ei:
                e.submit(**kw)
            reasons.append(ei.value.reason)
        assert isinstance(ei.value, SubmitRejected)
        assert reasons == [reason, reason]
    assert eng.queue == [] == jeng.queue
    for e in (jeng, eng):
        e.submit([1, 2], max_new=3)
    assert record(eng, eng.run_all()) == record(jeng, jeng.run_all())


@pytest.mark.parametrize("policy,limit", [("reject", 2), ("drop_oldest", 1)])
def test_bounded_admission_matches_jax(models, policy, limit):
    """queue_limit with either shed policy on one slot: the outcomes (uid,
    reason "queue_full", the evicted uids), shed_count, queue_peak and the
    drained statuses ("shed" with no output) equal the reference's."""
    ref, got, _, eng = run_both(
        models, [([1 + i, 2, 3], 3, None) for i in range(4)], slots=1,
        max_len=16, queue_limit=limit, shed_policy=policy)
    assert got == ref
    assert eng.shed_count == (2 if policy == "reject" else 3)
    statuses = [r[1] for r in got["requests"]]
    assert statuses.count("ok") == (2 if policy == "reject" else 1)
    if policy == "drop_oldest":
        assert [o[3] for o in got["outcomes"]] == [(), (1,), (2,), (3,)]


@pytest.mark.parametrize("case", ["midstream", "in_queue"])
def test_deadlines_match_jax(models, case):
    """A resident request past its deadline is cancelled mid-stream with
    its partial output; with ``default_deadline`` a request stuck behind a
    long one expires while queued, with no output — as in the
    reference."""
    if case == "midstream":
        submits, kw = [([1, 2, 3], 12, 4), ([4, 5, 6], 3, None)], {}
    else:
        submits, kw = [([1, 2, 3], 6, 50), ([4, 5, 6], 3, None)], \
            dict(default_deadline=2)
    ref, got, _, _ = run_both(models, submits, slots=1, **kw)
    assert got == ref
    (_, s1, out1, *_), (_, s2, out2, *_) = got["requests"]
    assert got["deadline_miss_count"] == 1
    if case == "midstream":
        assert s1 == "deadline" and 0 < len(out1) < 12 and s2 == "ok"
    else:
        assert (s1, s2, out2) == ("ok", "deadline", [])


def _drain_every_step(submits_late):
    """Fill both slots, step once, submit the waiters, then step and drain
    at every boundary (the reference's preemption parity loop)."""
    def run(e):
        for p in submits_late:
            e.submit(list(p), max_new=10)
        done = []
        for _ in range(200):
            if not (e.queue or e._occupied()):
                break
            e.step()
            done.extend(e.drain())
        return done + e.drain()
    return run


@pytest.mark.parametrize("form,spec_k", [("w", 0), ("qp", 0), ("w", 2)])
def test_preemption_parity_matches_jax(models, form, spec_k):
    """preempt_after=1 with waiters: every request is preempted at least
    once and requeued through bucketed admission with its committed
    tokens, drained at every step; tokens, preemption counts and ticks
    equal the reference's, and each stream equals the port's solo greedy
    ``generate``."""
    cfg, tp, pol = models["cfg"][1], models[form][1], models[form][3]
    ref, got, _, _ = run_both(
        models, [(p, 10, None) for p in PROMPTS[:2]], form=form,
        preempt_after=1, spec_k=spec_k, max_ticks=200,
        run=lambda e: (e.step(), _drain_every_step(PROMPTS[2:])(e))[1])
    assert got == ref
    assert all(r[3] >= 1 for r in got["requests"])
    assert got["preempt_count"] == sum(r[3] for r in got["requests"])
    for uid, status, out, *_ in got["requests"]:
        p = PROMPTS[uid - 1]
        solo = generate(tp, [p], cfg, policy=pol, max_new_tokens=10,
                        dtype=torch.float32, device="cpu")
        assert status == "ok" and out == solo[0, len(p):].tolist()


def test_preemption_with_early_eos_matches_jax(models):
    """EOS mid-stream while preemption churns: truncation lands where the
    reference's does and slots freed by EOS are seen again."""
    cfg, tp = models["cfg"][1], models["w"][1]
    full = generate(tp, [PROMPTS[0]], cfg, policy=FLOAT, max_new_tokens=8,
                    dtype=torch.float32, device="cpu")[0, 3:].tolist()
    eos = full[next(i for i in range(1, len(full))
                    if full[i] not in full[:i])]
    ref, got, _, _ = run_both(models, [(p, 8, None) for p in PROMPTS],
                              preempt_after=1, eos_id=eos, max_ticks=200)
    assert got == ref
    assert any(r[2][-1] == eos and len(r[2]) < 8 for r in got["requests"])


@pytest.mark.parametrize("step", ["spec->plain", "kernel->fallback", "retry"])
def test_ladder_matches_jax(models, step):
    """A tick failure walks the ladder as the reference does: spec ->
    plain on a spec engine (the drafter dropped, the records of both
    widths read right), kernels -> plain versions on a qp engine, and with
    ``degrade=False`` a same-graph retry per injected fault; the tokens
    are those of a run without faults."""
    kw = {"spec->plain": dict(form="w", spec_k=2, plan=dict(fail_ticks=[1])),
          "kernel->fallback": dict(form="qp", plan=dict(fail_ticks=[1])),
          "retry": dict(form="w", degrade=False,
                        plan=dict(fail_ticks=[0, 2]))}[step]
    submits = [([1, 2, 3], 7, None), ([4, 5, 6, 7], 6, None)]
    ref, got, jeng, eng = run_both(models, submits, **kw)
    clean, _, _, _ = run_both(models, submits, form=kw["form"])
    assert got == ref
    assert [r[2] for r in got["requests"]] == \
        [r[2] for r in clean["requests"]]
    want = {"spec->plain": [(1, "spec->plain")],
            "kernel->fallback": [(1, "kernel->fallback")],
            "retry": [(0, "retry"), (2, "retry")]}[step]
    assert eng.fallback_events == want
    assert (eng.spec_k, eng.matmul_mode, eng.attn_mode) == \
        (jeng.spec_k, jeng.matmul_mode, jeng.attn_mode)
    if step == "kernel->fallback":
        assert (eng.matmul_mode, eng.attn_mode) == ("dequant", "ref")


def test_admission_delay_matches_jax(models):
    """Injected admission stalls defer the queued request; admission
    resumes after them and both requests finish as in the reference."""
    ref, got, _, _ = run_both(
        models, [([1, 2, 3], 4, None), ([4, 5, 6], 4, None)], slots=1,
        max_ticks=100, plan=dict(delay_admission=[1, 2]))
    assert got == ref
    assert [r[1] for r in got["requests"]] == ["ok", "ok"]


@pytest.mark.parametrize("where", ["run_all", "constructor"])
def test_watchdog_matches_jax(models, where):
    """A wedged engine (admission stalled) trips the watchdog: both raise
    with the same diagnostics (keys and values), and the work finished
    before the wedge drains."""
    plan = dict(delay_admission=range(2, 10_000))
    kw = dict(max_ticks=12) if where == "constructor" else {}
    jeng, eng = pair(models, slots=1, plan=plan, **kw)
    diags, drained = [], []
    for e, exc in ((jeng, JWatchdogExpired), (eng, WatchdogExpired)):
        e.submit([1, 2, 3], max_new=3)
        e.submit([4, 5, 6], max_new=3)
        with pytest.raises(exc) as ei:
            e.run_all() if kw else e.run_all(max_ticks=12)
        diags.append(ei.value.diagnostics)
        drained.append(record(e, e.drain()))
    assert diags[1] == diags[0]
    assert diags[1]["queue_depth"] == 1 and diags[1]["active_slots"] == []
    assert drained[1] == drained[0]
    assert [r[:2] for r in drained[1]["requests"]] == [(1, "ok")]


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_fault_plan_random_matches_jax(seed):
    """FaultPlan.random draws the reference's plan from the same seed;
    plans are immutable values."""
    got = FaultPlan.random(seed, ticks=200, slots=4)
    ref = JFaultPlan.random(seed, ticks=200, slots=4)
    for name in ("nan_logits", "fail_ticks", "delay_admission", "flip_bits",
                 "crash_at_tick"):
        assert getattr(got, name) == getattr(ref, name), name
    assert not got.empty and FaultPlan().empty
    assert got == FaultPlan.random(seed, ticks=200, slots=4)
    with pytest.raises(dataclasses.FrozenInstanceError):
        got.fail_ticks = frozenset()


def test_chaos_matches_jax(models):
    """Seeded chaos (NaN logits, tick failures, admission stalls) over an
    overloaded spec engine with bounded admission, deadlines, preemption
    and the watchdog: every accepted request drains with a terminal
    status, and the two engines agree on everything."""
    submits = [(PROMPTS[i % len(PROMPTS)], 6, None) for i in range(8)]
    ref, got, _, eng = run_both(
        models, submits, queue_limit=4, shed_policy="drop_oldest",
        default_deadline=30, preempt_after=2, spec_k=2, max_ticks=300,
        plan=dict(nan_logits=[(2, 1), (9, 0)], fail_ticks=[3, 6],
                  delay_admission=[1, 4, 5]))
    assert got == ref
    assert len(got["requests"]) == sum(o[0] for o in got["outcomes"]) == 8
    assert got["shed_count"] > 0
    assert {r[1] for r in got["requests"]} <= set(STATUS)
    assert eng.fallback_events == [(3, "spec->plain"),
                                   (6, "kernel->fallback")]
    assert any(r[1] == "ok" for r in got["requests"])
