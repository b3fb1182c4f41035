"""The port's Mamba2 (ssm family) against the JAX package on the CPU, from
JAX-initialised weights bridged as numpy, fp32, no activation quant, at
``reduced(mamba2-2.7b)`` (2 layers, d_model 64, 8 SSD heads of 16, state
16):

- prefill of right-padded prompts with per-row ``lengths`` (chunk 4, so
  the SSD runs several chunks and the padding lands inside one; and the
  engine's chunk 256) and 6 decode steps, forms w / q / qp through the
  plain paths and qp through the kernel dispatch (the kernels' plain
  versions on CPU tensors): logits within 1e-5 x max|logit| of JAX's with
  the same argmax, and the decode state after each step within 1e-5 x its
  max;
- ``ssm_split_proj`` (four component projections, two convs) and
  ``ssm_bf16`` (the SSD products' operands rounded to bf16, summed in
  fp32, as the reference's bf16 einsums with an fp32 result): the same
  bound;
- greedy ``ServingEngine`` tokens equal the JAX engine's under staggered
  admission, also when every slot is preempted and requeued, after a
  snapshot -> restore into a fresh engine, and through the capture path's
  CPU stand-in graph (the warm-ups run the tick with every slot inactive,
  which folds a token into a recurrent state: the engine keeps the state
  across them);
- ``ssm`` refuses an int8 KV cache and speculative decoding with the
  reference's errors, and its state primitives write in place.

One JAX reference run per case is shared through module caches; torch runs
on one thread."""
import dataclasses
import functools

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

from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.core import graphs
from repro_torch.core.precision import FLOAT, W3A8
from repro_torch.core.treeutil import flatten_with_path
from repro_torch.models import api, mamba2
from repro_torch.serving.engine import ServingEngine

JW3 = dataclasses.replace(JW3A8, act_bits=None)
W3 = dataclasses.replace(W3A8, act_bits=None)
TOL = 1e-5                      # x max|logit|: fp32, sums in another order
PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17], [40]]
ENGINE_PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11],
                  [20, 21, 22, 23, 24, 25, 26, 27, 28], [30, 31, 32, 33],
                  [40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51]]
VARIANTS = {"base": {}, "split": dict(ssm_split_proj=True),
            "bf16": dict(ssm_bf16=True)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _master(variant):
    over = VARIANTS[variant]
    jcfg = dataclasses.replace(jreduced(jget_config("mamba2-2.7b")), **over)
    cfg = dataclasses.replace(reduced(get_config("mamba2-2.7b")), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg, jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)


@functools.lru_cache(maxsize=None)
def _forms(variant, form):
    jcfg, cfg, jp = _master(variant)
    if form == "w":
        jpol, pol = JFLOAT, FLOAT
    else:
        jpol, pol = JW3, W3
        jp = {"q": jqd.export_levels, "qp": jqd.export_container}[form](
            jp, jpol)
    return jcfg, cfg, jp, bridge.to_torch(jax.device_get(jp)), jpol, pol


def _prompts():
    toks = np.zeros((len(PROMPTS), 16), np.int32)
    for i, p in enumerate(PROMPTS):
        toks[i, :len(p)] = p
    return toks, np.array([len(p) for p in PROMPTS], np.int32)


@functools.lru_cache(maxsize=None)
def _jax_run(variant, form, chunk):
    """JAX's logits and states after prefill and after each of 6 decode
    steps. Jitted, as the reference serves: XLA may move a result by an
    ulp, well inside the tolerance."""
    jcfg, _, jp, _, jpol, _ = _forms(variant, form)
    kw = dict(policy=jpol, dtype=jnp.float32)
    prefill = jax.jit(lambda p, t, n: japi.prefill(
        p, {"tokens": t}, jcfg, lengths=n, chunk=chunk, **kw))
    decode = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, jcfg, **kw))
    toks, lens = _prompts()
    jl, jc = prefill(jp, jnp.asarray(toks), jnp.asarray(lens))
    steps = [jax.device_get((jl, jc))]
    for _ in range(6):
        nxt = np.asarray(jl[:, -1].argmax(-1), np.int32)[:, None]
        jl, jc = decode(jp, jc, jnp.asarray(nxt))
        steps.append(jax.device_get((jl, jc)))
    return steps


def _close(got, ref, what):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, err_msg=what,
                               atol=TOL * float(np.abs(ref).max()))


def _check(tl, tc, jl, jc, what):
    _close(tl, jl, what)
    assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all(), what
    for k in ("ssm", "conv"):
        assert tc["layers"][k].dtype == torch.float32
        _close(tc["layers"][k], jc["layers"][k], f"{what} state {k}")
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


@pytest.mark.parametrize("variant,form,modes,chunk", [
    ("base", "w", "dequant", 4), ("base", "q", "dequant", 4),
    ("base", "qp", "dequant", 4), ("base", "qp", "kernel", 4),
    ("base", "qp", "dequant", mamba2.DEFAULT_CHUNK),
    ("split", "qp", "dequant", 4), ("bf16", "qp", "dequant", 4)])
def test_model_matches_jax(variant, form, modes, chunk):
    """Right-padded prefill (per-row lengths) and 6 decode steps, logits and
    the decode state against JAX's."""
    _, cfg, _, tp, _, pol = _forms(variant, form)
    ref = _jax_run(variant, form, chunk)
    toks, lens = _prompts()
    kw = dict(policy=pol, dtype=torch.float32, matmul_mode=modes)
    tl, tc = api.prefill(tp, {"tokens": torch.tensor(toks)}, cfg,
                         lengths=torch.tensor(lens), chunk=chunk, **kw)
    _check(tl, tc, *ref[0], "prefill")
    leaves = [v.data_ptr() for v in tc["layers"].values()]
    for i in range(6):
        nxt = np.asarray(ref[i][0][:, -1].argmax(-1), np.int32)[:, None]
        tl, tc = api.decode_step(tp, tc, torch.tensor(nxt), cfg, **kw)
        _check(tl, tc, *ref[i + 1], f"decode {i}")
    # decode advanced the state in the tensors prefill made
    assert [v.data_ptr() for v in tc["layers"].values()] == leaves


def test_bf16_activations_keep_an_fp32_state():
    """bf16 activations: the carried conv and SSM states stay fp32 (a bf16
    conv tail drifts, and would change a captured buffer's dtype)."""
    _, cfg, _, tp, _, pol = _forms("base", "qp")
    cache = api.init_cache(cfg, 3, 32, torch.bfloat16, per_slot_len=True)
    toks = torch.tensor([[1], [2], [3]], dtype=torch.int32)
    for _ in range(2):
        logits, cache = api.decode_step(tp, cache, toks, cfg, policy=pol,
                                        dtype=torch.bfloat16)
    assert logits.dtype == torch.float32 and logits.isfinite().all()
    assert {v.dtype for v in cache["layers"].values()} == {torch.float32}
    np.testing.assert_array_equal(cache["len"].numpy(), [2, 2, 2])


def test_state_primitives_match_jax():
    """``insert_prefill_many`` (a padding row's slot out of range, dropped),
    ``insert_prefill`` and ``free_slots`` leave JAX's state, written into
    the engine's own tensors."""
    jcfg, cfg, _, tp, jpol, pol = _forms("base", "qp")
    ref = _jax_run("base", "qp", 4)
    jsrc, src = ref[0][1], bridge.to_torch(ref[0][1])
    jst = japi.init_cache(jcfg, 4, 32, jnp.float32, per_slot_len=True)
    st = api.init_cache(cfg, 4, 32, torch.float32, per_slot_len=True)
    ptrs = [v.data_ptr() for v in flatten_with_path(st).values()]
    slot_map = np.array([2, 9, 0], np.int32)
    jst = japi.insert_prefill_many(jcfg, jst, jnp.asarray(slot_map), jsrc)
    st = api.insert_prefill_many(cfg, st, torch.tensor(slot_map), src)
    one = {"layers": {k: v[:, 1:2] for k, v in jsrc["layers"].items()},
           "len": jsrc["len"][1]}
    jst = japi.insert_prefill(jcfg, jst, 3, one)
    st = api.insert_prefill(cfg, st, 3, bridge.to_torch(one))
    jst = japi.free_slots(jcfg, jst, jnp.asarray([0, 7]))
    st = api.free_slots(cfg, st, torch.tensor([0, 7]))
    want = flatten_with_path(bridge.to_torch(jax.device_get(jst)))
    got = flatten_with_path(st)
    assert [v.data_ptr() for v in got.values()] == ptrs
    for path, v in want.items():
        torch.testing.assert_close(got[path], v, rtol=0, atol=0)


def test_ssm_refuses_kv8_and_spec():
    """No KV cache to quantize and no state to rewind: an int8 KV cache and
    speculative decoding are refused as the reference refuses them, and the
    speculative entry points raise its error."""
    jcfg, cfg, jp, tp, jpol, pol = _forms("base", "qp")
    for eng, p, c, po in ((JServingEngine, jp, jcfg, jpol),
                          (ServingEngine, tp, cfg, pol)):
        dev = {} if eng is JServingEngine else {"device": "cpu"}
        with pytest.raises(ValueError, match="kv_bits=8 is meaningless"):
            eng(p, c, policy=po, slots=2, max_len=32, kv_bits=8, **dev)
        with pytest.raises(ValueError, match="speculative decoding is "
                                             "unavailable for family 'ssm'"):
            eng(p, c, policy=po, slots=2, max_len=32, spec_k=2, **dev)
    with pytest.raises(ValueError, match="kv_bits=8 is meaningless"):
        api.init_cache(cfg, 2, 32, kv_bits=8)
    cache = api.init_cache(cfg, 2, 32, per_slot_len=True)
    toks = torch.ones((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="cannot be rewound") as got:
        api.verify_step(tp, cache, toks, cfg, policy=pol)
    with pytest.raises(ValueError) as ref:
        japi.verify_step(jp, japi.init_cache(jcfg, 2, 32), jnp.ones(
            (2, 3), jnp.int32), jcfg, policy=jpol)
    assert str(got.value) == str(ref.value)
    for fn in (lambda: api.spec_state_snapshot(cfg, cache),
               lambda: api.rollback_cache(cfg, cache, [0], [1])):
        with pytest.raises(ValueError, match="cannot be rewound"):
            fn()


# --- engines ---------------------------------------------------------------------

def _staggered(eng, max_new=8):
    out = {}
    for p in ENGINE_PROMPTS[:3]:                 # first wave fills all slots
        out[int(eng.submit(p, max_new=max_new))] = tuple(p)
    eng.step(); eng.step()                       # decode in flight...
    for p in ENGINE_PROMPTS[3:]:                 # ...second wave queues up
        out[int(eng.submit(p, max_new=max_new))] = tuple(p)
    return {out[r.uid]: (r.status, list(r.out)) for r in eng.run_all()}


@functools.lru_cache(maxsize=None)
def _jax_engine():
    jcfg, _, jp, _, jpol, _ = _forms("base", "qp")
    eng = JServingEngine(jp, jcfg, policy=jpol, dtype=jnp.float32, slots=3,
                         max_len=40)
    return _staggered(eng), eng.decode_calls


def _engine(**kw):
    _, cfg, _, tp, _, pol = _forms("base", "qp")
    return ServingEngine(tp, cfg, policy=pol, dtype=torch.float32, slots=3,
                         max_len=40, device="cpu", **kw)


class _RecordedWork:
    """A CUDA graph's stand-in (as in tests/test_torch_capture.py): capture
    records the work without running it, replay runs it."""

    def __init__(self, fn, pool, generator):
        self.fn, self.launches = fn, {}

    def replay(self):
        self.fn()


def test_engine_token_identical_to_jax():
    """Staggered mixed-length admission, greedy: the JAX engine's tokens
    and tick count."""
    ref, ticks = _jax_engine()
    eng = _engine()
    assert _staggered(eng) == ref and len(ref) == len(ENGINE_PROMPTS)
    assert eng.decode_calls == ticks


def test_preempted_engine_token_identical_to_jax():
    """preempt_after=2 with waiters: slots are preempted, their rows zeroed
    (``free_slots``) and their requests re-admitted with their committed
    tokens; every stream equals the JAX engine's undisturbed one."""
    ref, _ = _jax_engine()
    eng = _engine(preempt_after=2)
    assert _staggered(eng) == ref
    assert eng.preempt_count > 0


def test_restored_engine_token_identical_to_jax(tmp_path):
    """A snapshot after 4 ticks restored into a fresh engine (the state tree
    written back into its own tensors) continues to the JAX engine's
    tokens."""
    ref, _ = _jax_engine()
    eng = _engine()
    out = {}
    for p in ENGINE_PROMPTS:
        out[int(eng.submit(p, max_new=8))] = tuple(p)
    for _ in range(4):
        eng.step()
    eng.snapshot(str(tmp_path))
    done = {out[r.uid]: (r.status, list(r.out)) for r in eng.drain()}
    fresh = _engine()
    ptrs = [v.data_ptr() for v in flatten_with_path(fresh.cache).values()]
    fresh.restore(str(tmp_path))
    assert [v.data_ptr() for v in flatten_with_path(fresh.cache).values()] \
        == ptrs
    done.update({out[r.uid]: (r.status, list(r.out))
                 for r in fresh.run_all()})
    assert done == ref


def test_replayed_engine_token_identical_to_jax(monkeypatch):
    """The capture path through the CPU stand-in graph: one tick capture,
    one per admission bucket, the JAX engine's tokens (the tick's warm-ups
    leave the live slots' recurrent state as they found it)."""
    monkeypatch.setattr(graphs, "_Graph", _RecordedWork)
    monkeypatch.setattr(graphs.torch.cuda, "graph_pool_handle", lambda: None)
    ref, ticks = _jax_engine()
    eng = _engine()
    eng.graphs.capture = True
    assert _staggered(eng) == ref
    assert eng.decode_calls == ticks
    assert eng.captures == {"tick": 1, "admit": {8: 1, 16: 1}}
