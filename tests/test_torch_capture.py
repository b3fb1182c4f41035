"""The engine's capture path on the CPU, where no CUDA graph exists: a stand-
in graph records the work at capture and replays it by calling it, while
``core.graphs`` does everything else as on the card — the warm-ups inside
the engine's idle contexts (every slot inactive for the tick, every row
dropped for an admission), the generator restored after them, the fixed
state, input and record buffers, one capture per key. At
``reduced(qwen2-1.5b)``, fp32, T = 0, from JAX-initialised weights bridged
as numpy; the replayed engine must serve exactly the JAX engine's tokens
(and at T > 0 the eager engine's stream from the same seed).

The graphs themselves (capture, replay, the kernels inside) run only on
the card: ``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import quant_dense as jqd
from repro.core.precision import FLOAT as JFLOAT, W3A8 as JW3A8
from repro.models import api as japi
from repro.models import get_model as jget_model
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.engine import generate as jgenerate
from repro.serving.resilience import FaultPlan as JFaultPlan

from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.core import graphs
from repro_torch.core.precision import FLOAT, W3A8
from repro_torch.kernels.qmatvec import kernel as qmv_k
from repro_torch.kernels.qmatvec import ref as qmv_ref
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import ServingEngine, generate
from repro_torch.serving.resilience import FaultPlan

JW3 = dataclasses.replace(JW3A8, act_bits=None)
W3 = dataclasses.replace(W3A8, act_bits=None)
PROMPTS = [
    [1, 2, 3],
    [7, 8, 9, 10, 11],
    [20, 21, 22, 23, 24, 25, 26, 27, 28],
    [30, 31, 32, 33],
    [40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51],
]


class _RecordedWork:
    """A CUDA graph's stand-in: capture records the work without running
    it, replay runs it."""

    def __init__(self, fn, pool, generator):
        self.fn, self.launches = fn, {}

    def replay(self):
        self.fn()


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(graphs, "_Graph", _RecordedWork)
    monkeypatch.setattr(graphs.torch.cuda, "graph_pool_handle", lambda: None)

    def replayed(eng):
        eng.graphs.capture = True
        return eng
    return replayed


@pytest.fixture(scope="module")
def models():
    """(jcfg, cfg, JAX master, port master, JAX qp, port qp)."""
    jcfg = jreduced(jget_config("qwen2-1.5b"))
    cfg = reduced(get_config("qwen2-1.5b"))
    jp = jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    jqp = jqd.export_container(jp, JW3)
    return (jcfg, cfg, jp, bridge.to_torch(jax.device_get(jp)), jqp,
            bridge.to_torch(jax.device_get(jqp)))


def _staggered(eng, max_new=6):
    uid_to_prompt = {}
    for p in PROMPTS[:3]:                        # first wave fills all slots
        uid_to_prompt[int(eng.submit(p, max_new=max_new))] = tuple(p)
    eng.step(); eng.step()                       # decode in flight...
    for p in PROMPTS[3:]:                        # ...second wave queues up
        uid_to_prompt[int(eng.submit(p, max_new=max_new))] = tuple(p)
    return {uid_to_prompt[r.uid]: (r.status, r.out) for r in eng.run_all()}


def test_capture_needs_a_card(models):
    _, cfg, _, tp, _, _ = models
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        ServingEngine(tp, cfg, policy=FLOAT, slots=2, max_len=32,
                      capture=True, device="cpu")
    eng = ServingEngine(tp, cfg, policy=FLOAT, slots=2, max_len=32,
                        device="cpu")
    assert not eng.graphs.capture
    assert eng.captures == {"tick": 0, "admit": {}}


@pytest.mark.parametrize("form,kv_bits,spec_k", [("qp", None, 0),
                                                 ("qp", 8, 0),
                                                 ("w", None, 0),
                                                 ("w", None, 2),
                                                 ("w", 8, 2)])
def test_replayed_engine_token_identical_to_jax(models, stand_in, form,
                                                kv_bits, spec_k):
    """Staggered mixed-length serving through replayed work: the JAX
    engine's tokens, ticks and accept counts; one tick capture and one
    capture per admission bucket used (8 and 16)."""
    jcfg, cfg, jp, tp, jqp, tqp = models
    jparams, params = (jqp, tqp) if form == "qp" else (jp, tp)
    jpol, pol = (JW3, W3) if form == "qp" else (JFLOAT, FLOAT)
    kw = dict(slots=3, max_len=40, kv_bits=kv_bits, spec_k=spec_k)
    if spec_k:
        jdcfg, jdp = japi.draft_of(jcfg, jp)
        jspec = dict(draft_params=jdp, draft_cfg=jdcfg)
        spec = dict(draft_params=bridge.to_torch(jax.device_get(jdp)),
                    draft_cfg=cfg)
    else:
        jspec = spec = {}
    jeng = JServingEngine(jparams, jcfg, policy=jpol, dtype=jnp.float32,
                          **jspec, **kw)
    eng = stand_in(ServingEngine(params, cfg, policy=pol, dtype=torch.float32,
                                 device="cpu", **spec, **kw))
    ref, got = _staggered(jeng), _staggered(eng)
    assert got == ref and len(got) == len(PROMPTS)
    assert (eng.decode_calls, eng.prefill_calls) == \
        (jeng.decode_calls, jeng.prefill_calls)
    assert (eng.spec_drafted, eng.spec_accepted) == \
        (jeng.spec_drafted, jeng.spec_accepted)
    assert eng.captures == {"tick": 1, "admit": {8: 1, 16: 1}}


def test_captures_bounded_by_bucket_count(models, stand_in):
    """Ten distinct prompt lengths, two buckets: at most one capture per
    bucket and one tick capture, however many admission rounds ran (the
    reference's ``test_retraces_bounded_by_bucket_count``)."""
    _, cfg, _, tp, _, _ = models
    eng = stand_in(ServingEngine(tp, cfg, policy=FLOAT, slots=2, max_len=32,
                                 dtype=torch.float32, device="cpu"))
    for ln in range(1, 11):
        eng.submit([1] * ln, max_new=2)
    done = eng.run_all()
    assert len(done) == 10 and eng.prefill_calls >= 4
    caps = eng.captures
    assert caps["tick"] == 1 and set(caps["admit"]) <= {8, 16}
    assert all(n == 1 for n in caps["admit"].values())
    assert sum(eng.graphs.captures.values()) == 1 + len(caps["admit"])


@pytest.mark.parametrize("spec_k", [0, 2])
def test_replayed_quarantine_matches_eager(models, stand_in, spec_k):
    """A FaultPlan NaN through replayed work gives the eager engine's
    statuses, tokens and poisoned_count."""
    _, cfg, _, tp, _, _ = models
    kw = dict(policy=FLOAT, slots=2, max_len=32, dtype=torch.float32,
              spec_k=spec_k, fault_plan=FaultPlan(nan_logits=[(1, 0), (3, 1)]),
              device="cpu")
    outs = []
    for eng in (ServingEngine(tp, cfg, **kw),
                stand_in(ServingEngine(tp, cfg, **kw))):
        for p in PROMPTS[:4]:
            eng.submit(p, max_new=7)
        outs.append(([(r.uid, r.status, r.out) for r in eng.run_all()],
                     eng.poisoned_count))
    assert outs[0] == outs[1]
    assert outs[0][1] == 2 and sum(s == "poisoned"
                                   for _, s, _ in outs[0][0]) == 2


@pytest.mark.parametrize("spec_k", [0, 2])
def test_replayed_sampling_matches_eager(models, stand_in, spec_k):
    """At T > 0 the warm-ups draw nothing for real (the generator is
    restored after them): the replayed engine samples the eager engine's
    stream from the same seed."""
    _, cfg, _, tp, _, _ = models
    kw = dict(policy=FLOAT, slots=3, max_len=40, dtype=torch.float32,
              temperature=0.9, seed=11, spec_k=spec_k, device="cpu")
    eager = _staggered(ServingEngine(tp, cfg, **kw))
    replayed = _staggered(stand_in(ServingEngine(tp, cfg, **kw)))
    assert replayed == eager
    greedy = _staggered(ServingEngine(tp, cfg, **dict(kw, temperature=0.0)))
    assert replayed != greedy                   # it did sample


def test_replayed_ladder_recaptures(models, stand_in):
    """The degradation ladder through replayed work: tick failures at 1 and
    3 walk a spec engine to the plain tick and then to the plain versions;
    each step drops the graphs and the next call captures again (three
    tick captures), the warm-ups' launches are booked apart, and the tokens
    and fallback_events equal the eager engine's and the JAX engine's."""
    jcfg, cfg, jp, tp, _, _ = models
    _, jdp = japi.draft_of(jcfg, jp)
    kw = dict(slots=3, max_len=40, spec_k=2)
    jeng = JServingEngine(jp, jcfg, policy=JFLOAT, dtype=jnp.float32,
                          draft_params=jdp, draft_cfg=jcfg,
                          fault_plan=JFaultPlan(fail_ticks=[1, 3]), **kw)
    engines = [ServingEngine(tp, cfg, policy=FLOAT, dtype=torch.float32,
                             draft_params=bridge.to_torch(
                                 jax.device_get(jdp)), draft_cfg=cfg,
                             fault_plan=FaultPlan(fail_ticks=[1, 3]),
                             device="cpu", **kw) for _ in range(2)]
    stand_in(engines[1])
    ref = _staggered(jeng)
    for eng in engines:
        assert _staggered(eng) == ref
        assert eng.fallback_events == jeng.fallback_events == \
            [(1, "spec->plain"), (3, "kernel->fallback")]
    assert engines[1].captures["tick"] == 3
    assert engines[0].captures == {"tick": 0, "admit": {}}
    assert engines[1].graphs.warmup_launches and \
        not engines[0].graphs.warmup_launches


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_restore_into_replayed_engine(models, stand_in, tmp_path,
                                      temperature):
    """A snapshot restored into an engine whose work is already captured
    continues as the donor did, at T = 0 and T > 0 (the generator state
    restored in place)."""
    _, cfg, _, tp, _, _ = models
    kw = dict(policy=FLOAT, slots=3, max_len=40, dtype=torch.float32,
              temperature=temperature, seed=5, device="cpu")
    donor = ServingEngine(tp, cfg, **kw)
    for p in PROMPTS:
        donor.submit(p, max_new=8)
    for _ in range(3):
        donor.step()
    donor.snapshot(str(tmp_path / "s"))
    mid = {r.uid: r.out for r in donor.drain()}
    want = {**mid, **{r.uid: r.out for r in donor.run_all()}}
    fresh = stand_in(ServingEngine(tp, cfg, **kw))
    _staggered(fresh)
    fresh.restore(str(tmp_path / "s"))
    assert {**mid, **{r.uid: r.out for r in fresh.run_all()}} == want
    assert fresh.captures["tick"] == 1


def test_counter_bookkeeping():
    """What a capture does with the launch counters: the counts the
    recording made are kept and taken back, and each replay adds them."""
    before = graphs.read_counters()
    qmv_k.launches += 3
    qmv_k.launches_by_variant["decode"] += 3
    qmv_ref.calls += 1
    delta = graphs._diff(graphs.read_counters(), before)
    name = qmv_k.__name__
    assert delta == {(name, "launches"): 3,
                     (name, "launches_by_variant"): {"decode": 3},
                     (qmv_ref.__name__, "calls"): 1}
    graphs._restore(before)
    assert graphs.read_counters() == before
    graphs._add(delta)
    graphs._add(delta)
    assert qmv_k.launches == before[(name, "launches")] + 6
    assert qmv_k.launches_by_variant["decode"] == \
        before[(name, "launches_by_variant")]["decode"] + 6
    graphs._restore(before)


def test_masked_restores_the_buffer():
    buf = torch.tensor([True, False, True])
    with graphs.masked(buf, False):
        assert not buf.any()
    assert buf.tolist() == [True, False, True]
    with pytest.raises(RuntimeError):
        with graphs.masked(buf, False):
            raise RuntimeError("work failed")
    assert buf.tolist() == [True, False, True]


# --- the paper pipeline's training step and evaluation forward --------------------

@pytest.fixture
def pipeline_stand_in(monkeypatch):
    """The pipeline's graphs replayed through the stand-in on the CPU
    (``capture=False`` still runs eagerly)."""
    from repro_torch.paper import pipeline

    class CPUGraphs(graphs.Graphs):
        def __init__(self, device, *, capture=None, generator=None):
            super().__init__(device, capture=False, generator=generator)
            self.capture = capture is not False

    monkeypatch.setattr(graphs, "_Graph", _RecordedWork)
    monkeypatch.setattr(graphs.torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(pipeline, "Graphs", CPUGraphs)
    return pipeline


@pytest.mark.parametrize("policy", [FLOAT, W3A8])
def test_replayed_training_step_matches_eager(pipeline_stand_in, policy):
    """The training step replayed (one capture for the one batch shape,
    warm-ups inside ``kept`` of the parameters and the momentum) trains the
    eager step's parameters bit for bit, with the same losses, and the
    replayed evaluation gives the eager MCR; the inputs are left as they
    were."""
    from repro_torch.core.treeutil import flatten_with_path
    from repro_torch.data import synthetic
    from repro_torch.models import dnn
    pipeline = pipeline_stand_in
    task = synthetic.digit_task(n_train=400, n_test=200)
    init = dnn.init(torch.Generator().manual_seed(3), 784, (32, 32), 10)
    before = {k: v.clone() for k, v in flatten_with_path(init).items()}
    kw = dict(policy=policy, epochs=2, batch=100, lr=0.1, momentum=0.9)
    runs = [pipeline.train_mlp(init, task, capture=c, **kw)
            for c in (False, True)]
    (p0, s0), (p1, s1) = runs
    assert (s0["captures"], s1["captures"]) == (0, 1)
    assert s0["final_loss"] == s1["final_loss"]
    for path, v in flatten_with_path(p0).items():
        assert torch.equal(flatten_with_path(p1)[path], v), path
        assert not flatten_with_path(p1)[path].requires_grad
    for path, v in flatten_with_path(init).items():
        assert torch.equal(v, before[path]), path
    assert pipeline.evaluate(p1, task, policy=policy, batch=50,
                             capture=False) == \
        pipeline.evaluate(p1, task, policy=policy, batch=50)


@pytest.fixture
def captured_generate(stand_in, monkeypatch):
    """``generate``'s graphs capture on the CPU through the stand-in unless
    asked for ``capture=False``; returns the Graphs each call made, the
    host reads of the speculative loop's done flag and the replays."""
    made, reads, replays = [], [], []

    class _Counted(_RecordedWork):
        def replay(self):
            replays.append(1)
            super().replay()
    monkeypatch.setattr(graphs, "_Graph", _Counted)

    class _Captured(graphs.Graphs):
        def __init__(self, device, *, capture=None, generator=None):
            super().__init__(device, capture=capture, generator=generator)
            self.capture = capture is not False
            made.append(self)
    monkeypatch.setattr(engine_mod, "Graphs", _Captured)
    rows_left = engine_mod._rows_left

    def counted(*args):
        reads.append(1)
        return rows_left(*args)
    monkeypatch.setattr(engine_mod, "_rows_left", counted)
    return made, reads, replays


@pytest.mark.parametrize("spec_k", [0, 4])
def test_captured_generate_token_identical(models, captured_generate,
                                           spec_k):
    """``generate`` with its decode step (spec_k 0) or speculative tick
    (spec_k 4) captured once and replayed: at T = 0 token-identical to
    ``capture=False`` and to JAX's ``generate`` (the float master, fp32);
    at T > 0 the eager stream from the same seed. The plain loop reads
    nothing from the device; the speculative one reads its done flag once
    every 4 replays, not once a tick."""
    jcfg, cfg, jp, tp, _, _ = models
    made, reads, replays = captured_generate
    prompts = np.array([[5, 6, 7, 8], [9, 1, 2, 3], [60, 61, 62, 63]],
                       np.int32)
    new = 9
    kw = dict(policy=FLOAT, dtype=torch.float32, max_new_tokens=new,
              spec_k=spec_k, device="cpu")
    ref = jgenerate(jp, jnp.asarray(prompts), jcfg, policy=JFLOAT,
                    dtype=jnp.float32, max_new_tokens=new, spec_k=spec_k)
    eager = generate(tp, prompts, cfg, capture=False, **kw)
    assert not made[-1].captures
    del reads[:]
    got = generate(tp, prompts, cfg, **kw)
    assert list(made[-1].captures.values()) == [1]
    if spec_k:
        assert 1 <= len(replays) <= new - 1
        assert len(reads) <= len(replays) // 4
    else:
        assert len(replays) == new - 1 and not reads
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), eager.numpy())
    hot = dict(kw, temperature=0.8, seed=3)
    sampled = generate(tp, prompts, cfg, **hot)
    assert torch.equal(sampled, generate(tp, prompts, cfg, capture=False,
                                         **hot))
    assert not torch.equal(sampled, got)            # it did sample


def test_generate_capture_needs_a_card(models):
    _, cfg, _, tp, _, _ = models
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        generate(tp, [[1, 2, 3]], cfg, policy=FLOAT, max_new_tokens=3,
                 capture=True, device="cpu")
