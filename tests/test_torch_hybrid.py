"""The port's Zamba2-style hybrid against the JAX package on the CPU, from
JAX-initialised weights bridged as numpy, fp32, no activation quant, at
``reduced(zamba2-1.2b, layers=5)``: two groups of two mamba blocks, each
followed by the one shared attention block (4 heads, MHA), and a one-block
tail.

- Prefill of right-padded prompts (per-row ``lengths``), 6 decode steps
  and a 5-token ``verify_step``, forms w / q / qp through the plain paths
  and qp through the kernel dispatch (the kernels' plain versions on CPU
  tensors), qp also with an int8 KV cache: logits within 1e-5 x
  max|logit| of JAX's with the same argmax, and verify's (T + 1)-snapshot
  trajectory of the mamba states within 1e-5 x its max. With an int8
  cache a K or V value within an ulp of a rounding tie may take the
  neighbouring level: levels agree within 1, and where one differs the
  logits are held to 2e-3 x max|logit| (as in
  ``tests/test_torch_dense_family.py``).
- Both exports of the bridged master equal JAX's leaf for leaf (groups
  fitted per (group, block)).
- ``rollback_cache`` with the verify trajectory: per-row snapshot select,
  K/V wipe and lengths equal JAX's, written into the live tensors.
- Greedy ``ServingEngine`` tokens equal the JAX engine's under staggered
  admission with a float and an int8 KV cache, and for speculative serving
  (spec_k 2: the float master verifies its qp drafter, both stateful, both
  rolled back through trajectories) with the same accept counts; the
  plain engine also when slots are preempted, after snapshot -> restore,
  and through the capture path's CPU stand-in graph.
- ``draft_of(depth_fraction=)`` slices whole groups as the reference does.
- musicgen-large (audio) and internvl2-26b (vlm) serve through ``api`` as
  the dense decoder: prefill + decode against JAX; the frontend helpers
  give the reference's shapes; ``get_model`` resolves every config.

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
from repro.configs.base import _MODULE_FOR as J_MODULE_FOR
from repro.core import quant_dense as jqd
from repro.core.precision import FLOAT as JFLOAT, W3A8 as JW3A8
from repro.models import api as japi
from repro.models import frontends as jfrontends
from repro.models import get_model as jget_model
from repro.serving.engine import ServingEngine as JServingEngine

from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.core import graphs, quant_dense
from repro_torch.core.precision import FLOAT, W3A8
from repro_torch.core.treeutil import flatten_with_path
from repro_torch.models import api, frontends
from repro_torch.serving.engine import ServingEngine

JW3 = dataclasses.replace(JW3A8, act_bits=None)
W3 = dataclasses.replace(W3A8, act_bits=None)
TOL = 1e-5                      # x max|logit|: fp32, sums in another order
TIE_TOL = 2e-3                  # x max|logit|: an int8 KV level moved by a tie
LAYERS = 5                      # 2 groups x attn_every 2, plus a tail block
PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17], [40]]
VERIFY = np.array([[5, 9, 2, 77, 3], [1, 1, 1, 1, 1], [100, 4, 8, 15, 16]],
                  np.int32)
ENGINE_PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11],
                  [20, 21, 22, 23, 24, 25, 26, 27, 28], [30, 31, 32, 33],
                  [40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51]]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _master(arch="zamba2-1.2b", layers=LAYERS):
    jcfg = jreduced(jget_config(arch), layers=layers)
    cfg = reduced(get_config(arch), layers=layers)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg, jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)


@functools.lru_cache(maxsize=None)
def _forms(form, arch="zamba2-1.2b", layers=LAYERS):
    jcfg, cfg, jp = _master(arch, layers)
    if form == "w":
        jpol, pol = JFLOAT, FLOAT
    else:
        jpol, pol = JW3, W3
        jp = jax.jit(lambda p: {"q": jqd.export_levels,
                                "qp": jqd.export_container}[form](p, jpol))(jp)
    return jcfg, cfg, jp, bridge.to_torch(jax.device_get(jp)), jpol, pol


def _prompts():
    toks = np.zeros((len(PROMPTS), 16), np.int32)
    for i, p in enumerate(PROMPTS):
        toks[i, :len(p)] = p
    return toks, np.array([len(p) for p in PROMPTS], np.int32)


@functools.lru_cache(maxsize=None)
def _jax_run(form, kv8, arch="zamba2-1.2b", layers=LAYERS):
    """JAX's logits and caches after prefill, after each of 6 decode steps
    and after the verify step (with its trajectory; None where the family
    has no verify). Jitted, as the reference serves."""
    jcfg, _, jp, _, jpol, _ = _forms(form, arch, layers)
    kw = dict(policy=jpol, dtype=jnp.float32)
    prefill = jax.jit(lambda p, t, n: japi.prefill(
        p, {"tokens": t}, jcfg, max_len=32, lengths=n, quantize_cache=kv8,
        **kw))
    decode = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, jcfg, **kw))
    verify = jax.jit(lambda p, c, t: japi.verify_step(p, c, t, jcfg, **kw))
    toks, lens = _prompts()
    jl, jc = prefill(jp, jnp.asarray(toks), jnp.asarray(lens))
    steps = [jax.device_get((jl, jc))]
    for _ in range(6):
        nxt = np.asarray(jl[:, -1].argmax(-1), np.int32)[:, None]
        jl, jc = decode(jp, jc, jnp.asarray(nxt))
        steps.append(jax.device_get((jl, jc)))
    if jcfg.family != "hybrid":
        return steps, None
    return steps, jax.device_get(verify(jp, jc, jnp.asarray(VERIFY)))


def _level_gap(tc, jc):
    """The largest difference of the int8 K/V levels at the positions each
    row holds (0 for a float cache); at most one level."""
    tc, jc, lens = tc["kv"], jc["kv"], np.asarray(jc["len"]).reshape(-1)
    if "k_scale" not in jc:
        return 0
    held = torch.arange(jc["k"].shape[2])[None, :] < torch.tensor(lens)[:, None]
    gap = max(int(((tc[n].int() - torch.tensor(np.asarray(jc[n])).int())
                   .abs().amax((-2, -1)) * held).max()) for n in ("k", "v"))
    assert gap <= 1, gap
    return gap


def _close(got, ref, what, tol=TOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, err_msg=what,
                               atol=tol * float(np.abs(ref).max()))


def _logits_close(tl, jl, what, tie=False):
    _close(tl, jl, what, TIE_TOL if tie else TOL)
    assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all(), what


def _trees_close(got, ref, what):
    ref = flatten_with_path(bridge.to_torch(ref))
    got = flatten_with_path(got)
    assert sorted(got) == sorted(ref), what
    for path, v in ref.items():
        assert got[path].shape == v.shape and got[path].dtype == v.dtype
        _close(got[path], v.numpy(), f"{what} {path}")


@pytest.mark.parametrize("form,modes,kv8", [
    ("w", ("dequant", "ref"), False), ("q", ("dequant", "ref"), False),
    ("qp", ("dequant", "ref"), False), ("qp", ("kernel", "kernel"), False),
    ("qp", ("dequant", "ref"), True), ("qp", ("kernel", "kernel"), True)])
def test_model_matches_jax(form, modes, kv8):
    """Prefill (right-padded, per-row lengths), 6 decode steps and a 5-token
    verify_step against the live cache: logits, the mamba states after
    each step and verify's trajectory against JAX's."""
    _, cfg, _, tp, _, pol = _forms(form)
    steps, (vl, vc, vtraj) = _jax_run(form, kv8)
    toks, lens = _prompts()
    mm, am = modes
    kw = dict(policy=pol, dtype=torch.float32, matmul_mode=mm, attn_mode=am)
    tl, tc = api.prefill(tp, {"tokens": torch.tensor(toks)}, cfg, max_len=32,
                         lengths=torch.tensor(lens), quantize_cache=kv8, **kw)
    _logits_close(tl, steps[0][0], "prefill")
    ptrs = {p: v.data_ptr() for p, v in flatten_with_path(tc).items()
            if p != "len"}
    for i in range(6):
        nxt = np.asarray(steps[i][0][:, -1].argmax(-1), np.int32)[:, None]
        tl, tc = api.decode_step(tp, tc, torch.tensor(nxt), cfg, **kw)
        jl, jc = steps[i + 1]
        _logits_close(tl, jl, f"decode {i}", tie=_level_gap(tc, jc) > 0)
        for name in ("groups", "tail"):
            _trees_close(tc[name], jc[name], f"decode {i} {name}")
    tl, tc, traj = api.verify_step(tp, tc, torch.tensor(VERIFY), cfg, **kw)
    assert tl.shape == (3, 5, cfg.vocab_size)
    _logits_close(tl, vl, "verify", tie=_level_gap(tc, vc) > 0)
    _trees_close(traj, vtraj, "trajectory")
    for name in ("groups", "tail"):
        _trees_close(tc[name], vc[name], f"verify {name}")
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(vc["len"]))
    # every step wrote into the tensors prefill made
    assert {p: v.data_ptr() for p, v in flatten_with_path(tc).items()
            if p != "len"} == ptrs


@pytest.mark.parametrize("form", ["q", "qp"])
def test_exports_match_jax(form):
    """The port's export of the bridged master equals JAX's leaf for leaf:
    ``groups`` leaves are fitted per (group, block) — two stacked dims,
    delta (G, A, 1, N) — ``tail`` per block, the shared block unstacked;
    levels and words bit for bit, deltas within 1e-6."""
    jcfg, cfg, jp = _master()
    *_, jx, tx, _, pol = _forms(form)
    export = {"q": quant_dense.export_levels,
              "qp": quant_dense.export_container}[form]
    own = flatten_with_path(export(bridge.to_torch(jax.device_get(jp)), pol))
    ref = flatten_with_path(jax.device_get(jx))
    assert sorted(own) == sorted(ref) == sorted(flatten_with_path(tx))
    g, a = cfg.num_layers // cfg.attn_every, cfg.attn_every
    n_in = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
    assert own["groups/in_proj/delta"].shape == (g, a, 1, n_in)
    assert own["tail/in_proj/delta"].shape == (1, 1, n_in)
    assert own["shared/attn/wq/delta"].shape == (1, cfg.d_model)
    for path, r in ref.items():
        got = own[path].numpy()
        assert got.shape == r.shape and got.dtype == r.dtype, path
        if path.endswith("delta"):
            np.testing.assert_allclose(got, r, rtol=1e-6, err_msg=path)
        else:
            np.testing.assert_array_equal(got, r, err_msg=path)


def test_rollback_matches_jax():
    """Rows rewound to 0, 2, 5 of the 5 verified tokens (and one slot out
    of range): each row's snapshot restored, the wiped K/V zeroed and the
    lengths as JAX's, in the live tensors."""
    jcfg, cfg, jp, tp, jpol, pol = _forms("qp")
    steps, (_, vc, vtraj) = _jax_run("qp", False)
    cache = bridge.to_torch(vc)
    ptrs = {p: v.data_ptr() for p, v in flatten_with_path(cache).items()}
    traj = bridge.to_torch(vtraj)
    cur = np.asarray(vc["len"])
    slots = np.array([0, 1, 2, 7], np.int32)
    new = np.array([cur[0] - 5, cur[1] - 3, cur[2], 3], np.int32)
    ref = japi.rollback_cache(jcfg, jax.tree_util.tree_map(jnp.asarray, vc),
                              jnp.asarray(slots), jnp.asarray(new),
                              jax.tree_util.tree_map(jnp.asarray, vtraj))
    got = api.rollback_cache(cfg, cache, torch.tensor(slots),
                             torch.tensor(new), traj)
    want = flatten_with_path(bridge.to_torch(jax.device_get(ref)))
    for path, v in flatten_with_path(got).items():
        torch.testing.assert_close(v, want[path], rtol=0, atol=0)
        if path != "len":
            assert v.data_ptr() == ptrs[path], path


def test_draft_of_slices_whole_groups():
    """``draft_of(depth_fraction=0.5)`` keeps the first group and the tail
    (the reference's config and tree paths), exported to qp."""
    jcfg, cfg, jp, tp, _, _ = _forms("w")
    jdcfg = japi.draft_of(jcfg, jp, depth_fraction=0.5,
                          policy=JFLOAT)[0]          # no export: the cfg
    want = jax.eval_shape(lambda p: japi.draft_of(
        jcfg, p, depth_fraction=0.5)[1], jp)
    dcfg, dp = api.draft_of(cfg, tp, depth_fraction=0.5)
    assert dataclasses.asdict(dcfg) == dataclasses.asdict(jdcfg)
    assert dcfg.num_layers == 3
    want = {p: tuple(v.shape) for p, v in flatten_with_path(want).items()}
    assert {p: tuple(v.shape) for p, v in flatten_with_path(dp).items()} \
        == want


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
def _spec(which):
    """The JAX qp drafter of the float master (bridged for the port, so a
    delta fit that ends an ulp apart cannot move a level)."""
    jcfg, cfg, jp, _, _, _ = _forms("w")
    jdp = jax.jit(lambda p: japi.draft_of(jcfg, p)[1])(jp)
    if which == "jax":
        return dict(draft_params=jdp, draft_cfg=jcfg)
    return dict(draft_params=bridge.to_torch(jax.device_get(jdp)),
                draft_cfg=cfg)


@functools.lru_cache(maxsize=None)
def _jax_engine(kv_bits, spec_k):
    jcfg, _, jp, _, jpol, _ = _forms("w" if spec_k else "qp")
    eng = JServingEngine(jp, jcfg, policy=jpol, dtype=jnp.float32, slots=3,
                         max_len=40, kv_bits=kv_bits, spec_k=spec_k,
                         **(_spec("jax") if spec_k else {}))
    return (_staggered(eng), eng.decode_calls, eng.spec_drafted,
            eng.spec_accepted)


def _engine(kv_bits=None, spec_k=0, **kw):
    _, cfg, _, tp, _, pol = _forms("w" if spec_k else "qp")
    return ServingEngine(tp, cfg, policy=pol, dtype=torch.float32, slots=3,
                         max_len=40, kv_bits=kv_bits, spec_k=spec_k,
                         device="cpu", **(_spec("torch") if spec_k else {}),
                         **kw)


@pytest.mark.parametrize("kv_bits,spec_k", [(None, 0), (8, 0), (None, 2)])
def test_engine_token_identical_to_jax(kv_bits, spec_k):
    """Staggered mixed-length admission, greedy: the JAX engine's tokens,
    ticks and (spec) accept counts."""
    ref, ticks, drafted, accepted = _jax_engine(kv_bits, spec_k)
    eng = _engine(kv_bits, spec_k)
    assert _staggered(eng) == ref and len(ref) == len(ENGINE_PROMPTS)
    assert (eng.decode_calls, eng.spec_drafted, eng.spec_accepted) == \
        (ticks, drafted, accepted)
    if spec_k:
        assert 0 < accepted < drafted


def test_preempted_engine_token_identical_to_jax():
    """preempt_after=2 with waiters: preempted rows are zeroed
    (``free_slots``: mamba states, K/V, length) and their requests
    re-admitted with their committed tokens; every stream equals the JAX
    engine's undisturbed one."""
    ref, *_ = _jax_engine(None, 0)
    eng = _engine(preempt_after=2)
    assert _staggered(eng) == ref
    assert eng.preempt_count > 0


def test_restored_engine_token_identical_to_jax(tmp_path):
    """A snapshot after 4 ticks restored into a fresh engine (the state tree
    written back into its own tensors) continues to the JAX engine's
    tokens."""
    ref, *_ = _jax_engine(None, 0)
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


class _RecordedWork:
    """A CUDA graph's stand-in (as in tests/test_torch_capture.py): capture
    records the work without running it, replay runs it."""

    def __init__(self, fn, pool, generator):
        self.fn, self.launches = fn, {}

    def replay(self):
        self.fn()


@pytest.mark.parametrize("spec_k", [0, 2])
def test_replayed_engine_token_identical_to_jax(monkeypatch, spec_k):
    """The capture path through the CPU stand-in graph, plain and
    speculative: one tick capture, one per admission bucket, the JAX
    engine's tokens (the tick's warm-ups leave the live slots' mamba
    states as they found them)."""
    monkeypatch.setattr(graphs, "_Graph", _RecordedWork)
    monkeypatch.setattr(graphs.torch.cuda, "graph_pool_handle", lambda: None)
    ref, ticks, *_ = _jax_engine(None, spec_k)
    eng = _engine(spec_k=spec_k)
    eng.graphs.capture = True
    assert _staggered(eng) == ref
    assert eng.decode_calls == ticks
    assert eng.captures == {"tick": 1, "admit": {8: 1, 16: 1}}


# --- audio / vlm, frontends, dispatch ----------------------------------------------

@pytest.mark.parametrize("arch", ["musicgen-large", "internvl2-26b"])
def test_frontend_families_match_jax(arch):
    """The audio and vlm configs serve through ``api`` as the dense decoder
    (musicgen's gelu MLP, MHA; internvl2's GQA): prefill and 6 decode
    steps of the qp export against JAX."""
    _, cfg, _, tp, _, pol = _forms("qp", arch, 2)
    steps, _ = _jax_run("qp", False, arch, 2)
    toks, lens = _prompts()
    kw = dict(policy=pol, dtype=torch.float32)
    tl, tc = api.prefill(tp, {"tokens": torch.tensor(toks)}, cfg, max_len=32,
                         lengths=torch.tensor(lens), **kw)
    _logits_close(tl, steps[0][0], "prefill")
    for i in range(6):
        nxt = np.asarray(steps[i][0][:, -1].argmax(-1), np.int32)[:, None]
        tl, tc = api.decode_step(tp, tc, torch.tensor(nxt), cfg, **kw)
        _logits_close(tl, steps[i + 1][0], f"decode {i}")


@pytest.mark.parametrize("arch", ["musicgen-large", "internvl2-26b",
                                  "qwen2-1.5b"])
def test_frontend_helpers_match_jax(arch):
    """``frontend_embed_shape`` and ``text_len`` as the reference's; the
    synthetic embeddings have that shape, the dtype asked for and a 0.02
    scale."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    assert frontends.frontend_embed_shape(cfg, 3) == \
        jfrontends.frontend_embed_shape(jcfg, 3)
    for n in (1, 100, 4096):
        assert frontends.text_len(cfg, n) == jfrontends.text_len(jcfg, n)
    gen = torch.Generator().manual_seed(0)
    x = frontends.synthetic_frontend_embeds(gen, cfg, 2)
    assert tuple(x.shape) == frontends.frontend_embed_shape(cfg, 2)
    assert x.dtype == torch.bfloat16
    assert 0.015 < float(x.float().std()) < 0.025


def test_every_config_resolves():
    """Every config of the reference has the port's copy, and ``get_model``
    gives the family module the reference's does (the paper's MLP configs
    have none in either)."""
    assert set(J_MODULE_FOR) <= set(
        __import__("repro_torch.configs.base", fromlist=["x"])._MODULE_FOR)
    for name in J_MODULE_FOR:
        jcfg, cfg = jget_config(name), get_config(name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        try:
            want = jget_model(jcfg).__name__.rsplit(".", 1)[1]
        except KeyError:
            with pytest.raises(KeyError):
                api.get_model(cfg)
            continue
        assert api.get_model(cfg).__name__.rsplit(".", 1)[1] == want
