"""The port's LM training substrate against the JAX package on the CPU:

- the schedules at steps 0..N to 1e-7 x their peak lr and
  ``clip_by_global_norm`` to 1e-7 relative; AdamW (with and without
  weight decay) and SGD in-place updates given identical grads within
  1e-6 x max|update| over two steps; ``grad_transform`` before the clip;
- ``lm_batch``: deterministic in (seed, step), a shifted stream, every
  transition inside its window ``(31 x + 17 + [0, vocab // 16)) % vocab``
  (its stream is not ``jax.random``'s, so every parity test below feeds
  both packages JAX's numpy batches);
- ``prefetch`` order, error propagation and a stopped worker;
  ``HostLoader`` restarted from ``start_step``; ``StragglerMonitor`` counts
  equal to JAX's for one dt sequence;
- ``make_train_step`` at ``reduced(qwen2-1.5b, layers=2, d_model=32,
  vocab=64)``, fp32 compute: 3 steps (AdamW, warmup_cosine, clip 1.0)
  from bridged params on JAX's batches, float and weight-only W3 with
  JAX's frozen deltas in ``state["deltas"]``: losses, gnorm and lr per
  step within 1e-5 relative (parameters after Adam steps are not compared
  element by element: a gradient within rounding of 0 can flip the sign
  of an update by 2 lr; the update itself is held by the optimizer tests);
  under full W3A8 (act_bits 8, deltas refitted each step) within 1e-3
  relative, outside the parity bar (the 8-bit signals round differently
  for inputs that differ in the last ulp); ``microbatches=2`` against 1 as
  ``tests/test_training.py`` holds the reference;
- a JAX ``TrainState`` saved by ``repro.checkpoint`` at step 2, restored by
  ``repro_torch.checkpoint.restore``: one port step gives JAX's step-3
  loss and gnorm within 1e-5 relative; ``bridge.to_torch`` carries a
  whole JAX ``TrainState`` bit for bit;
- the capture path through a CPU stand-in graph (capture records the work,
  each replay runs it): 4 replayed steps equal the eager steps bit for
  bit, with a different lr at every step, one capture, and the graph's
  warm-ups leaving the state as it was (a real capture, and an lr frozen
  into it, show only on the card: ``tests/test_torch_gpu.py``); a state
  handed in later is copied into the step's own tensors;
- ``Trainer`` with async checkpoints every 2 steps, restored and continued
  equal to an uninterrupted run; ``launch/train.py --reduced --device cpu
  --steps 8`` in-process: its loss decreases;
  ``launch/train_lm_100m.py``'s config and recipe are the reference
  example's."""
import dataclasses
import functools
import importlib.util
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import optim as joptim
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import quant_dense as jqd
from repro.core.precision import FLOAT as JFLOAT, W3A8 as JW3A8
from repro.data.synthetic import lm_batch as jlm_batch
from repro.models import get_model as jget_model
from repro.training.loop import StragglerMonitor as JStragglerMonitor
from repro.training.loop import make_train_step as jmake_train_step

from repro_torch import bridge, checkpoint, optim
from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.core import graphs
from repro_torch.core.precision import FLOAT, W3A8
from repro_torch.core.treeutil import flatten_with_path
from repro_torch.data import pipeline
from repro_torch.data.synthetic import lm_batch
from repro_torch.training import loop
from repro_torch.training.loop import (StragglerMonitor, Trainer,
                                       make_train_step)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JW3 = dataclasses.replace(JW3A8, act_bits=None)
W3 = dataclasses.replace(W3A8, act_bits=None)
POLICIES = {"float": (JFLOAT, FLOAT), "w3": (JW3, W3),
            "w3a8": (JW3A8, W3A8)}
TCFG = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
            grad_clip=1.0)
BATCH, SEQ = 8, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- optimizer and schedules -------------------------------------------------

SCHEDULES = {    # (schedule of the module, its peak lr)
    "constant": (lambda m: m.constant_schedule(3e-4), 3e-4),
    "cosine": (lambda m: m.cosine_schedule(1e-3, 20, final_frac=0.1), 1e-3),
    "warmup_cosine": (lambda m: m.warmup_cosine(1e-3, 5, 25), 1e-3),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_jax(name):
    """Steps 0..31 (past the end) within 1e-7 x the peak lr: XLA's and
    torch's cos differ by an ulp, which ``1 + cos`` amplifies near the
    end of the cosine."""
    make, peak = SCHEDULES[name]
    jfn, fn = make(joptim), make(optim)
    for step in range(32):
        want = np.float32(jfn(jnp.asarray(step, jnp.int32)))
        got = fn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - float(want)) <= 1e-7 * peak, step


def _tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {"a": {"w": (rng.randn(7, 5) * scale).astype(np.float32)},
            "b": (rng.randn(11) * scale).astype(np.float32),
            "c": {"d": {"w": (rng.randn(3, 4, 2) * scale).astype(np.float32)}}}


def _close(got, want, rel):
    for path, w in flatten_with_path(want).items():
        g = flatten_with_path(got)[path]
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert np.abs(g - w).max() <= rel * max(np.abs(w).max(), 1e-30), path


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    """Clipping on (0.5) and off (1e3): the norm and the leaves that the
    in-place clip scales, to 1e-7 relative of JAX's."""
    g = _tree(0)
    jclipped, jnorm = joptim.clip_by_global_norm(g, max_norm)
    tg = bridge.to_torch(g)
    np.testing.assert_allclose(float(optim.global_norm(tg)),
                               float(joptim.global_norm(g)), rtol=1e-7)
    norm = optim.clip_by_global_norm_(tg, max_norm)
    assert norm.dtype == torch.float32 and norm.shape == ()
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-7)
    _close(tg, jax.device_get(jclipped), 1e-7)


@pytest.mark.parametrize("name,hp", [("adamw", {}),
                                     ("adamw", {"weight_decay": 0.1}),
                                     ("sgd", {})])
def test_optimizer_updates_match_jax(name, hp):
    """Two in-place updates (``update_``, the captured step's form) from
    identical grads, on the port's own copies of the inputs: each step's
    update, read as the parameters' change on both sides, and the new
    state within 1e-6 x max|x| of JAX's."""
    params, lr = _tree(1), 3e-3
    jopt, opt = joptim.make(name, **hp), optim.make(name, **hp)
    jstate, jparams = jopt.init(params), params
    tparams = bridge.to_torch(params)
    state = opt.init(tparams)
    for i in range(2):
        g = _tree(10 + i, scale=0.1 if i else 1.0)
        jupd, jstate = jopt.update(g, jstate, jparams,
                                   jnp.asarray(lr, jnp.float32))
        jbefore = jax.device_get(jparams)
        jparams = joptim.apply_updates(jparams, jupd)
        jmoved = jax.tree_util.tree_map(np.subtract, jbefore,
                                        jax.device_get(jparams))
        before = optim.tree_map(torch.clone, tparams)
        opt.update_(bridge.to_torch(g), state, tparams,
                    torch.tensor(lr, dtype=torch.float32))
        _close(optim.tree_map(torch.sub, before, tparams), jmoved, 1e-6)
        _close(state, jax.device_get(jstate), 1e-6)
    if name == "adamw":
        assert state["count"].dtype == torch.int32 and int(state["count"]) == 2
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.make("lion")


# --- data --------------------------------------------------------------------

def test_lm_batch_deterministic():
    a = lm_batch(0, 7, batch=4, seq=16, vocab=64)
    b = lm_batch(0, 7, batch=4, seq=16, vocab=64)
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["labels"], b["labels"])
    for other in (lm_batch(0, 8, batch=4, seq=16, vocab=64),
                  lm_batch(1, 7, batch=4, seq=16, vocab=64)):
        assert not torch.equal(a["tokens"], other["tokens"])


def test_lm_batch_is_a_shifted_stream():
    d = lm_batch(0, 0, batch=2, seq=32, vocab=64)
    assert d["tokens"].dtype == torch.int32 and d["tokens"].shape == (2, 32)
    assert torch.equal(d["tokens"][:, 1:], d["labels"][:, :-1])


@pytest.mark.parametrize("vocab", [64, 8192, 20])
def test_lm_batch_transitions_inside_their_window(vocab):
    """Every next token is (31 x + 17 + n) % vocab with 0 <= n < max(vocab
    // 16, 2), as the reference's stream (checked on it too)."""
    window = max(vocab // 16, 2)
    for d in (lm_batch(3, 5, batch=4, seq=64, vocab=vocab),
              jax.device_get(jlm_batch(jnp.asarray(3), jnp.asarray(5),
                                       batch=4, seq=64, vocab=vocab))):
        x, y = (np.asarray(d[k], np.int64) for k in ("tokens", "labels"))
        assert x.min() >= 0 and y.max() < vocab
        assert ((y - (31 * x + 17)) % vocab < window).all()


def test_prefetch_order_errors_and_stop():
    assert list(pipeline.prefetch(iter(range(10)))) == list(range(10))

    def bad():
        yield from range(3)
        raise KeyError("boom")
    got = []
    with pytest.raises(KeyError, match="boom"):
        for x in pipeline.prefetch(bad()):
            got.append(x)
    assert got == [0, 1, 2]

    def endless():
        i = 0
        while True:
            yield i
            i += 1
    before = threading.active_count()
    it = pipeline.prefetch(endless())
    assert [next(it) for _ in range(5)] == list(range(5))
    it.close()                       # the worker stops with the consumer
    assert threading.active_count() == before


def test_host_loader_restarts_from_its_step():
    fn = lambda seed, s: lm_batch(seed, s, batch=2, seq=8, vocab=64)
    full = pipeline.HostLoader(fn, seed=4)
    it = iter(full)
    batches = [next(it) for _ in range(6)]
    it.close()
    it = iter(pipeline.HostLoader(fn, seed=4, start_step=3, device="cpu"))
    for want in batches[3:]:
        got = next(it)
        assert all(torch.equal(got[k], want[k]) for k in want)
    it.close()


def test_straggler_monitor_matches_jax():
    dts = [0.1] * 10 + [0.15, 0.5, 0.11, 0.3, 0.09, 0.25, 0.1, 1.0, 0.12]
    a, b = StragglerMonitor(factor=2.0), JStragglerMonitor(factor=2.0)
    assert [a.record(dt) for dt in dts] == [b.record(dt) for dt in dts]
    assert (a.slow_steps, a.total_steps, a.ema) == \
        (b.slow_steps, b.total_steps, b.ema)
    assert a.slow_steps == 4


# --- the train step against JAX ----------------------------------------------

@functools.lru_cache(maxsize=None)
def _tiny():
    """(jcfg, cfg, JAX master, JAX's frozen deltas)."""
    kw = dict(layers=2, d_model=32, vocab=64)
    jcfg, cfg = jreduced(jget_config("qwen2-1.5b"), **kw), \
        reduced(get_config("qwen2-1.5b"), **kw)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, jax.device_get(jqd.fit_deltas_stacked(jp, JW3A8))


@functools.lru_cache(maxsize=None)
def _jbatch(step, batch=BATCH):
    return jax.device_get(jlm_batch(jnp.asarray(0), jnp.asarray(step),
                                    batch=batch, seq=SEQ, vocab=64))


def _extra(policy, deltas):
    return {"deltas": deltas} if policy == "w3" else None


@functools.lru_cache(maxsize=None)
def _jtrajectory(policy, steps=3):
    jcfg, _, jp, jd = _tiny()
    step, init = jmake_train_step(jcfg, JTrainConfig(**TCFG),
                                  POLICIES[policy][0], dtype=jnp.float32)
    step = jax.jit(step)
    state = init(jp, extra=_extra(policy, jd))
    out = []
    for i in range(steps):
        state, m = step(state, _jbatch(i))
        out.append({k: float(m[k]) for k in ("loss", "gnorm", "lr")})
    return out


def _port_run(policy, steps=3, capture=None, tcfg=None):
    _, cfg, jp, jd = _tiny()
    step, init = make_train_step(cfg, tcfg or TrainConfig(**TCFG),
                                 POLICIES[policy][1], dtype=torch.float32,
                                 capture=capture)
    state = init(bridge.to_torch(jax.device_get(jp)),
                 extra=_extra(policy, bridge.to_torch(jd)))
    out = []
    for i in range(steps):
        state, m = step(state, bridge.to_torch(_jbatch(i)))
        out.append({k: float(v) for k, v in m.items()})
    return step, state, out


@pytest.mark.parametrize("policy", ["float", "w3"])
def test_three_step_trajectory_matches_jax(policy):
    want = _jtrajectory(policy)
    _, state, got = _port_run(policy)
    assert int(state["step"]) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "gnorm", "lr"):
            assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]), (i, k, g[k], w[k])
    assert got[0]["lr"] == 0.0 and got[1]["lr"] != got[2]["lr"]
    assert got[0]["gnorm"] > TCFG["grad_clip"]        # the clip is active


def test_a_later_state_is_copied_into_the_step(loop_stand_in):
    """The replayed step reads its own tensors: a state handed to it later
    (a restore) is copied into them, and the step continues from it."""
    _, cfg, jp, _ = _tiny()
    step, init = make_train_step(cfg, TrainConfig(**TCFG), FLOAT,
                                 dtype=torch.float32)
    fresh = lambda: init(bridge.to_torch(jax.device_get(jp)))
    own, m0 = step(fresh(), bridge.to_torch(_jbatch(0)))
    step(own, bridge.to_torch(_jbatch(1)))
    again = fresh()
    got, m = step(again, bridge.to_torch(_jbatch(0)))
    assert got is own and got is not again
    assert {k: float(v) for k, v in m.items()} == \
        {k: float(v) for k, v in m0.items()}
    assert int(got["step"]) == 1
    with pytest.raises(ValueError, match="structure differs"):
        step({"params": again["params"]}, bridge.to_torch(_jbatch(0)))


def test_grad_transform_runs_before_the_clip():
    """A ``grad_transform`` that zeroes the gradients: the clip sees a
    global norm of 0 and AdamW moves nothing."""
    _, cfg, jp, _ = _tiny()
    step, init = make_train_step(
        cfg, TrainConfig(**TCFG), FLOAT, dtype=torch.float32,
        grad_transform=lambda g, st: (optim.tree_map(torch.zeros_like, g),
                                      st))
    params = bridge.to_torch(jax.device_get(jp))
    before = {k: v.clone() for k, v in flatten_with_path(params).items()}
    state = init(params)
    for i in range(2):
        state, m = step(state, bridge.to_torch(_jbatch(i)))
        assert float(m["gnorm"]) == 0.0
    for path, v in flatten_with_path(state["params"]).items():
        assert torch.equal(v, before[path]), path


def test_full_w3a8_trajectory_near_jax():
    """Outside the parity bar: 8-bit activations and refitted deltas."""
    want = _jtrajectory("w3a8")
    _, _, got = _port_run("w3a8")
    for i, (g, w) in enumerate(zip(got, want)):
        assert abs(g["loss"] - w["loss"]) <= 1e-3 * abs(w["loss"]), i


def test_microbatch_equivalence():
    """2 microbatches == 1 big batch, held as the reference's
    ``test_microbatch_equivalence`` holds JAX: loss within 1e-5, params
    within rtol 2e-4, atol 1e-5 after one lr=1e-2 step."""
    out = {}
    for n in (1, 2):
        tcfg = TrainConfig(learning_rate=1e-2, microbatches=n,
                           total_steps=10, warmup_steps=0)
        _, state, m = _port_run("float", steps=1, tcfg=tcfg)
        out[n] = (torch.cat([v.reshape(-1) for v in
                             flatten_with_path(state["params"]).values()]),
                  m[0]["loss"])
    np.testing.assert_allclose(out[1][1], out[2][1], rtol=1e-5)
    np.testing.assert_allclose(out[1][0].numpy(), out[2][0].numpy(),
                               rtol=2e-4, atol=1e-5)


def test_jax_checkpoint_continues_in_the_port(tmp_path):
    """A JAX TrainState saved at step 2 (``repro.checkpoint``), restored by
    the port: its step 3 has JAX's loss and gnorm within 1e-5 relative."""
    jcfg, cfg, jp, _ = _tiny()
    jstep, jinit = jmake_train_step(jcfg, JTrainConfig(**TCFG), JFLOAT,
                                    dtype=jnp.float32)
    jstep = jax.jit(jstep)
    state = jinit(jp)
    for i in range(2):
        state, _ = jstep(state, _jbatch(i))
    jckpt.save(str(tmp_path), 2, state)
    _, want = jstep(state, _jbatch(2))
    tree, meta = checkpoint.restore(str(tmp_path), device="cpu")
    assert meta["step"] == 2 and int(tree["step"]) == 2
    assert tree["opt"]["count"].dtype == torch.int32
    step, _ = make_train_step(cfg, TrainConfig(**TCFG), FLOAT,
                              dtype=torch.float32)
    _, got = step(tree, bridge.to_torch(_jbatch(2)))
    for k in ("loss", "gnorm", "lr"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * abs(
            float(want[k])), k


def test_bridge_carries_a_jax_train_state():
    """params, AdamW m / v / count, step and deltas (None where JAX has
    None), bit for bit, int32 counters kept int32."""
    jcfg, _, jp, jd = _tiny()
    jstep, jinit = jmake_train_step(jcfg, JTrainConfig(**TCFG), JW3,
                                    dtype=jnp.float32)
    state, _ = jax.jit(jstep)(jinit(jp, extra={"deltas": jd}), _jbatch(0))
    host = jax.device_get(state)
    got = bridge.to_torch(host)
    assert got["deltas"]["layers"]["ln1"]["scale"] is None
    want = flatten_with_path(host)
    assert sorted(flatten_with_path(got)) == sorted(want)
    for path, w in want.items():
        g = flatten_with_path(got)[path]
        assert np.array_equal(g.numpy(), np.asarray(w)), path
        assert str(g.dtype).removeprefix("torch.") == str(np.asarray(w).dtype)


# --- capture through a CPU stand-in graph ------------------------------------

class _RecordedWork:
    """A CUDA graph's stand-in: capture records the work without running
    it, replay runs it."""

    def __init__(self, fn, pool, generator):
        self.fn, self.launches = fn, {}

    def replay(self):
        self.fn()


@pytest.fixture
def loop_stand_in(monkeypatch):
    class CPUGraphs(graphs.Graphs):
        def __init__(self, device, *, capture=None, generator=None):
            super().__init__(device, capture=False, generator=generator)
            self.capture = capture is not False

    monkeypatch.setattr(graphs, "_Graph", _RecordedWork)
    monkeypatch.setattr(graphs.torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(loop, "Graphs", CPUGraphs)


@pytest.mark.parametrize("policy", ["float", "w3a8"])
def test_replayed_step_matches_eager(loop_stand_in, policy):
    """4 replayed steps (one capture; the warm-ups inside ``kept`` of the
    state) equal 4 eager steps bit for bit: metrics, parameters, AdamW
    state and step; the lr differs at every step."""
    runs = {c: _port_run(policy, steps=4, capture=c) for c in (False, None)}
    (es, est, em), (rs, rst, rm) = runs[False], runs[None]
    assert es.captures == {} and list(rs.captures.values()) == [1]
    assert em == rm
    assert len({m["lr"] for m in rm}) == 4
    assert int(rst["step"]) == 4 and int(rst["opt"]["count"]) == 4
    for path, v in flatten_with_path(est).items():
        assert torch.equal(flatten_with_path(rst)[path], v), path


# --- Trainer and the launchers -----------------------------------------------

def _loader(start=0):
    return pipeline.HostLoader(
        lambda seed, s: bridge.to_torch(_jbatch(s)), start_step=start)


def test_trainer_checkpoints_restore_and_continue(tmp_path):
    """Async checkpoints every 2 steps; a restart from step 4 continues to
    the uninterrupted run's state after 6 steps, bit for bit."""
    _, cfg, jp, _ = _tiny()
    tcfg = TrainConfig(**TCFG)

    def trainer(ck=None):
        step, init = make_train_step(cfg, tcfg, FLOAT, dtype=torch.float32)
        return Trainer(step, init(bridge.to_torch(jax.device_get(jp))),
                       checkpointer=ck, ckpt_every=2, log_every=1)

    full = trainer()
    full.run(_loader(), 6)
    ck = checkpoint.Checkpointer(str(tmp_path), keep=2)
    part = trainer(ck)
    part.run(_loader(), 4)
    assert checkpoint.all_steps(str(tmp_path)) == [2, 4]
    assert [r["step"] for r in part.history] == [1, 2, 3, 4]
    tree, meta = checkpoint.restore(str(tmp_path), device="cpu")
    resumed = trainer()
    resumed.state = tree
    resumed.run(_loader(meta["step"]), 2)
    for path, v in flatten_with_path(full.state).items():
        assert torch.equal(flatten_with_path(resumed.state)[path], v), path
    assert resumed.history[-1]["loss"] == full.history[-1]["loss"]
    assert full.monitor.total_steps == 6


def test_train_launcher_loss_decreases():
    from repro_torch.launch import train
    tr = train.main(["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
                     "--steps", "8"])
    assert [r["step"] for r in tr.history] == [1, 8]
    first, last = tr.history[0]["loss"], tr.history[-1]["loss"]
    assert np.isfinite([first, last]).all() and last < first
    # the 2x16x16 mesh needs a group of 512 processes: this one has one
    with pytest.raises(RuntimeError, match="needs 512 processes"):
        train.main(["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
                    "--mesh", "multi"])


def test_lm_100m_matches_the_reference_example():
    from repro_torch.launch import train_lm_100m
    spec = importlib.util.spec_from_file_location(
        "ref_train_lm_100m", ROOT / "examples" / "train_lm_100m.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert dataclasses.asdict(train_lm_100m.make_100m_cfg()) == \
        dataclasses.asdict(ref.make_100m_cfg())
    assert dataclasses.asdict(train_lm_100m.train_config(300)) == \
        dataclasses.asdict(JTrainConfig(learning_rate=3e-4, total_steps=300,
                                        warmup_steps=20, optimizer="adamw",
                                        remat="layer"))
