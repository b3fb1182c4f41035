"""The port's speculative serving against the JAX package on the CPU, at
``reduced(qwen2-1.5b)`` (2 layers, d_model 64, vocab 128): the float master
(``w`` form, FLOAT policy) is the target, its packed 3-bit ``qp`` export
(``api.draft_of``) the drafter, fp32, no activation quant, from
JAX-initialised weights bridged as numpy.

Tolerances: tokens, accept lengths, accept counts and packed words
identical; verify logits within 1e-5 x max|logit| of JAX's, caches within
1e-5 (fp32; the two sum in another order); attention within 1e-5 (fp32) /
2e-2 (bf16) x max|ref|; at T > 0 the emitted tokens within a total
variation of 0.05 of the target distribution (8000 draws)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core.precision import FLOAT as JFLOAT
from repro.kernels.attn_prefill import ops as jpf_ops
from repro.models import api as japi
from repro.models import get_model as jget_model
from repro.models.attention import verify_attention as jverify_attention
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.engine import generate as jgenerate
from repro.serving.spec import emit_counts as jemit_counts
from repro.serving.spec import spec_accept as jspec_accept

from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.core.precision import FLOAT
from repro_torch.core.treeutil import flatten_with_path
from repro_torch.kernels.attn_prefill import ref as pf_ref
from repro_torch.models import api
from repro_torch.models.attention import verify_attention
from repro_torch.serving.engine import ServingEngine, SubmitRejected, generate
from repro_torch.serving.spec import emit_counts, spec_accept

SPEC_K = 4
PROMPTS = [
    [1, 2, 3],
    [7, 8, 9, 10, 11],
    [20, 21, 22, 23, 24, 25, 26, 27, 28],
    [30, 31, 32, 33],
    [40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51],
]


@pytest.fixture(scope="module")
def models():
    """(jcfg, cfg, JAX master, port master): the same weights."""
    jcfg = jreduced(jget_config("qwen2-1.5b"))
    cfg = reduced(get_config("qwen2-1.5b"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, bridge.to_torch(jax.device_get(jp))


def _np(x):
    return np.asarray(x, np.float32)


# --- accept -----------------------------------------------------------------------

def test_greedy_accept_matches_jax():
    """T = 0: the accept lengths, emitted windows and next tokens are JAX's
    (drafts built to match the target's argmax up to a random point)."""
    rng = np.random.default_rng(0)
    b, k, v = 6, SPEC_K, 16
    tl = rng.standard_normal((b, k + 1, v)).astype(np.float32)
    dl = rng.standard_normal((b, k, v)).astype(np.float32)
    drafts = tl[:, :k].argmax(-1).astype(np.int32)
    for i, cut in enumerate([0, 1, 2, 3, 4, 4]):
        if cut < k:
            drafts[i, cut] = (drafts[i, cut] + 1) % v
    ja, jout, jnxt = jspec_accept(jnp.asarray(drafts), jnp.asarray(dl),
                                  jnp.asarray(tl), temperature=0.0,
                                  key=jax.random.PRNGKey(0))
    a, out, nxt = spec_accept(torch.tensor(drafts), torch.tensor(dl),
                              torch.tensor(tl), temperature=0.0)
    assert a.tolist() == np.asarray(ja).tolist() == [0, 1, 2, 3, 4, 4]
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


@pytest.mark.parametrize("eos_id", [-1, 5])
def test_emit_counts_matches_jax(eos_id):
    rng = np.random.default_rng(1)
    b = 16
    out = rng.integers(0, 8, (b, SPEC_K + 1)).astype(np.int32)
    a = rng.integers(0, SPEC_K + 1, (b,)).astype(np.int32)
    active = rng.random(b) < 0.8
    emitted = rng.integers(1, 6, (b,)).astype(np.int32)
    budget = emitted + rng.integers(0, 7, (b,)).astype(np.int32)
    jn, jdone = jemit_counts(jnp.asarray(out), jnp.asarray(a),
                             active=jnp.asarray(active),
                             emitted=jnp.asarray(emitted),
                             budget=jnp.asarray(budget), eos_id=eos_id)
    n, done = emit_counts(torch.tensor(out), torch.tensor(a),
                          active=torch.tensor(active),
                          emitted=torch.tensor(emitted),
                          budget=torch.tensor(budget), eos_id=eos_id)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))


def test_sampled_accept_follows_target_distribution():
    """T > 0, the speculative sampling lemma: the first emitted token
    (accepted draft or residual resample) follows the TARGET's softmax for
    a drafter that is far from it, as tests/test_spec_accept.py measures
    it; and a drafter equal to the target is always accepted."""
    v, temp, n = 6, 0.8, 8000
    rng = np.random.default_rng(7)
    tl = (rng.standard_normal((1, 2, v)) * 1.5).astype(np.float32)
    dl = (rng.standard_normal((1, 1, v)) * 1.5).astype(np.float32)
    p_t = torch.softmax(torch.tensor(tl[0, 0]) / temp, -1).numpy()
    p_d = torch.softmax(torch.tensor(dl[0, 0]) / temp, -1).numpy()
    gen = torch.Generator().manual_seed(3)
    drafts = torch.multinomial(torch.tensor(p_d).expand(n, v), 1,
                               replacement=True, generator=gen)
    _, out, _ = spec_accept(drafts, torch.tensor(dl).expand(n, 1, v),
                            torch.tensor(tl).expand(n, 2, v),
                            temperature=temp, generator=gen)
    emp = np.bincount(out[:, 0].numpy(), minlength=v) / n
    tv = 0.5 * np.abs(emp - p_t).sum()
    assert tv < 0.05, (tv, emp, p_t)
    assert 0.5 * np.abs(p_d - p_t).sum() > 0.15, "drafter too close"
    logits = torch.tensor(rng.standard_normal((2, SPEC_K + 1, 16)),
                          dtype=torch.float32)
    d = torch.tensor(rng.integers(0, 16, (2, SPEC_K)))
    for t in (0.7, 2.5):
        a, _, _ = spec_accept(d, logits[:, :SPEC_K], logits, temperature=t,
                              generator=gen)
        assert a.tolist() == [SPEC_K, SPEC_K]


# --- verify attention -------------------------------------------------------------

def _verify_inputs(quantized, dtype, seed=2, b=4, t=5, s=24, kv=2, g=3, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, kv * g, d)).astype(np.float32)
    if quantized:
        k = rng.integers(-127, 128, (b, s, kv, d)).astype(np.int8)
        v = rng.integers(-127, 128, (b, s, kv, d)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (b, s)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (b, s)).astype(np.float32)
    else:
        k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
        v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
        ks = vs = None
    # ragged frontiers (one at the whole cache), one row with no valid key
    lens = np.array([0, 3, 11, s - t], np.int32)[:b]
    valid = np.minimum(lens[:, None] + np.arange(1, t + 1)[None, :], s)
    valid[0] = 0
    j = [jnp.asarray(q, dtype)] + [None if a is None else jnp.asarray(a)
                                   for a in (k, v, valid, ks, vs)]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    if not quantized:
        j[1], j[2] = j[1].astype(dtype), j[2].astype(dtype)
    tt = [bridge.to_torch(jax.device_get(a)) if a is not None else None
          for a in j]
    assert tt[0].dtype == tdt
    return j, tt


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("quantized", [False, True])
def test_verify_attention_matches_jax(dtype, quantized):
    """Ref mode against JAX's einsum; kernel mode (on CPU tensors the
    attn_prefill plain version) against JAX's attn_prefill kernel in
    interpret mode; a query with no valid key gives exact zeros."""
    j, t = _verify_inputs(quantized, dtype)
    tol = 1e-5 if dtype == jnp.float32 else 2e-2
    jref = jverify_attention(*j[:4], k_scale=j[4], v_scale=j[5], mode="ref")
    jker = jpf_ops.attn_prefill(*j[:4], k_scale=j[4], v_scale=j[5], bt=8,
                                bs=8, interpret=True)
    calls = pf_ref.calls
    for mode, want in (("ref", jref), ("kernel", jker)):
        got = verify_attention(*t[:4], k_scale=t[4], v_scale=t[5], mode=mode)
        assert got.shape == t[0].shape and got.dtype == t[0].dtype
        scale = float(np.abs(_np(want)).max())
        np.testing.assert_allclose(got.float().numpy(), _np(want),
                                   atol=tol * scale, rtol=0, err_msg=mode)
        assert (got[0] == 0).all()
    assert pf_ref.calls == calls + 2     # both stood in for the kernel


# --- model: verify_step, rollback_cache, draft_of ----------------------------------

def _prefilled(models, kv8, lens=(3, 7, 12)):
    jcfg, cfg, jp, tp = models
    toks = np.zeros((len(lens), max(16, max(lens))), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = np.arange(1, n + 1) * (i + 3) % 127 + 1
    kw = dict(max_len=32, quantize_cache=kv8)
    _, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                         policy=JFLOAT, dtype=jnp.float32,
                         lengths=jnp.asarray(np.array(lens, np.int32)), **kw)
    _, tc = api.prefill(tp, {"tokens": torch.tensor(toks)}, cfg, policy=FLOAT,
                        dtype=torch.float32,
                        lengths=torch.tensor(np.array(lens, np.int32)), **kw)
    return jc, tc


def _assert_caches_close(tc, jc, atol=1e-5):
    assert set(tc) == set(jc)
    for name in jc:
        np.testing.assert_allclose(tc[name].float().numpy(), _np(jc[name]),
                                   atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("attn_mode", ["ref", "kernel"])
def test_verify_step_matches_jax(models, kv8, attn_mode):
    jcfg, cfg, jp, tp = models
    jc, tc = _prefilled(models, kv8)
    toks = np.array([[5, 9, 2, 77, 3], [1, 1, 1, 1, 1], [100, 4, 8, 15, 16]],
                    np.int32)
    jl, jc, jtraj = japi.verify_step(jp, jc, jnp.asarray(toks), jcfg,
                                     policy=JFLOAT, dtype=jnp.float32)
    tl, tc, traj = api.verify_step(tp, tc, torch.tensor(toks), cfg,
                                   policy=FLOAT, dtype=torch.float32,
                                   attn_mode=attn_mode)
    assert traj is None and jtraj is None and tl.shape == (3, 5, 128)
    scale = float(np.abs(_np(jl)).max())
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-5 * scale, rtol=0)
    assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
    _assert_caches_close(tc, jc, atol=1e-5 if not kv8 else 1.0)
    if kv8:                              # int8 levels may differ by a tie
        assert (tc["k"].int() - torch.tensor(np.asarray(jc["k"])).int()
                ).abs().max() <= 1


def test_verify_step_past_the_cache_writes_nothing(models):
    """Positions past the cache are dropped, as the reference's scatter
    drops them: the rows' in-range entries and the last slot agree."""
    jcfg, cfg, jp, tp = models
    jc, tc = _prefilled(models, False, lens=(29, 30, 31))
    toks = np.array([[5, 9, 2, 77, 3]] * 3, np.int32)
    jl, jc, _ = japi.verify_step(jp, jc, jnp.asarray(toks), jcfg,
                                 policy=JFLOAT, dtype=jnp.float32)
    tl, tc, _ = api.verify_step(tp, tc, torch.tensor(toks), cfg, policy=FLOAT,
                                dtype=torch.float32)
    _assert_caches_close(tc, jc)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, rtol=0)


@pytest.mark.parametrize("kv8", [False, True])
def test_rollback_cache_matches_jax(models, kv8):
    """Rewind to the reference's lengths, the wiped entries (and int8
    scales) zeroed; a zero-distance or out-of-range rewind is the
    identity."""
    jcfg, cfg, jp, tp = models
    jc, tc = _prefilled(models, kv8)
    toks = np.array([[5, 9, 2, 77, 3]] * 3, np.int32)
    _, jc, _ = japi.verify_step(jp, jc, jnp.asarray(toks), jcfg,
                                policy=JFLOAT, dtype=jnp.float32)
    _, tc, _ = api.verify_step(tp, tc, torch.tensor(toks), cfg, policy=FLOAT,
                               dtype=torch.float32)
    before = {n: t.clone() for n, t in tc.items()}
    same = api.rollback_cache(cfg, tc, np.array([0, 1, 2]),
                              np.asarray(before["len"]))
    oob = api.rollback_cache(cfg, same, np.array([3, 7]), np.array([0, 0]))
    for n in before:
        assert torch.equal(oob[n], before[n]), n
    slots, new = np.array([2, 0, 5]), np.array([13, 4, 0], np.int32)
    jc = japi.rollback_cache(jcfg, jc, jnp.asarray(slots), jnp.asarray(new))
    tc = api.rollback_cache(cfg, tc, slots, new)
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist() == [4, 12, 13]
    _assert_caches_close(tc, jc, atol=1e-5 if not kv8 else 1.0)
    for i, (lo, hi) in enumerate(zip(tc["len"].tolist(),
                                     before["len"].tolist())):
        for name in tc:                  # the wiped band is exact zeros
            if name != "len":
                assert (tc[name][:, i, lo:hi] == 0).all(), name


@pytest.mark.parametrize("kv8", [False, True])
def test_rollback_equals_the_unspeculated_cache(models, kv8):
    """Verify [x0, d1..d4], keep x0 and d1: the cache equals one that only
    decoded x0 and d1 (the rejected entries zeroed, never written there),
    and the next decode step gives the same logits."""
    _, cfg, _, tp = models
    # unpadded prompts, so nothing but zeros lies past any row's length
    _, spec = _prefilled(models, kv8, lens=(16, 16, 16))
    _, plain = _prefilled(models, kv8, lens=(16, 16, 16))
    toks = torch.tensor([[5, 9, 2, 77, 3], [1, 6, 1, 1, 1],
                         [100, 4, 8, 15, 16]], dtype=torch.int32)
    kw = dict(policy=FLOAT, dtype=torch.float32)
    lens = spec["len"].clone()
    _, spec, _ = api.verify_step(tp, spec, toks, cfg, **kw)
    spec = api.rollback_cache(cfg, spec, np.arange(3), lens + 2)
    for j in range(2):
        _, plain = api.decode_step(tp, plain, toks[:, j:j + 1], cfg, **kw)
    assert spec["len"].tolist() == plain["len"].tolist()
    for name in plain:
        np.testing.assert_allclose(spec[name].float().numpy(),
                                   plain[name].float().numpy(),
                                   atol=1e-5 if not kv8 else 1.0, rtol=0,
                                   err_msg=name)
    nxt = torch.tensor([[11], [12], [13]], dtype=torch.int32)
    ls, _ = api.decode_step(tp, spec, nxt, cfg, **kw)
    lp, _ = api.decode_step(tp, plain, nxt, cfg, **kw)
    np.testing.assert_allclose(ls.numpy(), lp.numpy(),
                               atol=1e-4 * float(lp.abs().max()), rtol=0)


@pytest.mark.parametrize("depth", [1.0, 0.5])
def test_draft_of_matches_jax(models, depth):
    """The drafter's packed words are JAX's bit for bit (deltas within
    1e-6), at full and half depth."""
    jcfg, cfg, jp, tp = models
    jdcfg, jdp = japi.draft_of(jcfg, jp, depth_fraction=depth)
    dcfg, dp = api.draft_of(cfg, tp, depth_fraction=depth)
    assert dcfg.num_layers == jdcfg.num_layers == int(2 * depth)
    ref = flatten_with_path(jax.device_get(jdp))
    got = flatten_with_path(dp)
    assert sorted(ref) == sorted(got)
    assert any(p.endswith("/qp") for p in got)
    for path, r in ref.items():
        g = got[path].numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, path
        if path.endswith("delta"):
            np.testing.assert_allclose(g, r, rtol=1e-6, err_msg=path)
        else:
            np.testing.assert_array_equal(g, r, err_msg=path)
    with pytest.raises(ValueError):
        api.draft_of(cfg, tp, depth_fraction=0.0)


def test_spec_tick_freezes_a_non_finite_row(models):
    """``spec_decode_tick`` with a NaN ``logit_bias`` on one row: that row's
    ``row_ok`` is False and it is frozen (both caches rewound to its old
    length, the rewound band zeroed, its pending token held) while the
    others commit 1 + accept_len tokens."""
    from repro_torch.models import transformer
    from repro_torch.serving.spec import spec_decode_tick
    _, cfg, _, tp = models
    dcfg, dp = api.draft_of(cfg, tp)
    toks = torch.tensor([[5, 6, 7, 8]] * 3, dtype=torch.int32)
    kw = dict(policy=FLOAT, dtype=torch.float32, max_len=24)
    _, cache = api.prefill(tp, {"tokens": toks}, cfg, **kw)
    _, dcache = api.prefill(dp, {"tokens": toks}, dcfg, **kw)
    for c in (cache, dcache):
        c["len"] = c["len"].reshape(-1).expand(3).clone()
    pending = torch.tensor([[9], [10], [11]], dtype=torch.int32)
    bias = torch.tensor([0.0, float("nan"), 0.0])
    mkw = dict(policy=FLOAT, dtype=torch.float32)
    cache, dcache, a, out, nxt, ok = spec_decode_tick(
        transformer, transformer, tp, dp, cfg, dcfg, cache, dcache, pending,
        torch.ones(3, dtype=torch.bool), spec_k=SPEC_K, temperature=0.0,
        mkw=mkw, dmkw=mkw, logit_bias=bias)
    assert ok.tolist() == [True, False, True]
    want = [4 + 1 + int(a[0]), 4, 4 + 1 + int(a[2])]
    assert cache["len"].tolist() == dcache["len"].tolist() == want
    assert int(nxt[1, 0]) == 10
    for c in (cache, dcache):
        assert (c["k"][:, 1, 4:] == 0).all() and (c["v"][:, 1, 4:] == 0).all()


# --- serving ----------------------------------------------------------------------

def test_generate_spec_matches_jax_and_plain(models):
    """generate(spec_k=4) is token-identical to JAX's spec generate and to
    the port's plain greedy generate (each side derives its own drafter)."""
    jcfg, cfg, jp, tp = models
    prompts = np.array([[5, 6, 7, 8], [9, 1, 2, 3], [60, 61, 62, 63]],
                       np.int32)
    kw = dict(max_new_tokens=9)
    ref = jgenerate(jp, jnp.asarray(prompts), jcfg, policy=JFLOAT,
                    dtype=jnp.float32, spec_k=SPEC_K, **kw)
    got = generate(tp, prompts, cfg, policy=FLOAT, dtype=torch.float32,
                   spec_k=SPEC_K, device="cpu", **kw)
    plain = generate(tp, prompts, cfg, policy=FLOAT, dtype=torch.float32,
                     device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def _staggered(eng, max_new=8):
    out = {}
    for p in PROMPTS[:3]:                        # first wave fills all slots
        out[int(eng.submit(p, max_new=max_new))] = tuple(p)
    eng.step(); eng.step()                       # decode in flight...
    for p in PROMPTS[3:]:                        # ...second wave queues up
        out[int(eng.submit(p, max_new=max_new))] = tuple(p)
    return {out[r.uid]: r for r in eng.run_all()}


@pytest.mark.parametrize("kv_bits", [None, 8])
@pytest.mark.parametrize("depth", [1.0, 0.5])
def test_engine_spec_matches_jax(models, kv_bits, depth):
    """ServingEngine(spec_k=4) against JAX's under staggered mixed-length
    admission, the same (bridged) drafter on both sides: the same tokens
    per request, ticks and accept histograms, the same spec_drafted and
    spec_accepted; and the port's plain engine serves the same tokens."""
    jcfg, cfg, jp, tp = models
    jdcfg, jdp = japi.draft_of(jcfg, jp, depth_fraction=depth)
    dp = bridge.to_torch(jax.device_get(jdp))
    kw = dict(slots=3, max_len=40, kv_bits=kv_bits)
    jeng = JServingEngine(jp, jcfg, policy=JFLOAT, dtype=jnp.float32,
                          spec_k=SPEC_K, draft_params=jdp, draft_cfg=jdcfg,
                          **kw)
    eng = ServingEngine(tp, cfg, policy=FLOAT, dtype=torch.float32,
                        spec_k=SPEC_K, draft_params=dp, draft_cfg=jdcfg,
                        device="cpu", **kw)
    plain = ServingEngine(tp, cfg, policy=FLOAT, dtype=torch.float32,
                          device="cpu", **kw)
    ref, got, got0 = _staggered(jeng), _staggered(eng), _staggered(plain)
    assert len(got) == len(PROMPTS)
    for p, r in ref.items():
        assert got[p].out == r.out and len(r.out) == 8, p
        assert got0[p].out == r.out, p
        assert (got[p].ticks, got[p].accept_hist) == (r.ticks, r.accept_hist)
        assert sum(n * c for n, c in got[p].accept_hist.items()) == 7
    assert (eng.spec_drafted, eng.spec_accepted) == \
        (jeng.spec_drafted, jeng.spec_accepted)
    assert 0 < eng.spec_accepted < eng.spec_drafted   # real rejections
    assert eng.spec_accept_rate == jeng.spec_accept_rate
    assert eng.decode_calls < plain.decode_calls
    assert plain.spec_accept_rate == 0.0
    assert all(r.accept_hist == {1: 7} for r in got0.values())


def test_engine_spec_eos_and_sampling(models):
    """An EOS inside an accepted window cuts the request where plain
    decoding cuts it; at T > 0 the spec engine serves every request its
    tokens, all in the vocabulary."""
    _, cfg, _, tp = models
    kw = dict(slots=2, max_len=40, dtype=torch.float32, device="cpu")
    eng = ServingEngine(tp, cfg, policy=FLOAT, **kw)
    eng.submit(PROMPTS[1], max_new=10)
    ref = eng.run_all()[0].out
    idx = next(i for i in range(2, len(ref)) if ref[i] not in ref[:i])
    for spec_k in (0, SPEC_K):
        eng = ServingEngine(tp, cfg, policy=FLOAT, eos_id=ref[idx],
                            spec_k=spec_k, **kw)
        eng.submit(PROMPTS[1], max_new=10)
        assert eng.run_all()[0].out == ref[:idx + 1], spec_k
    eng = ServingEngine(tp, cfg, policy=FLOAT, temperature=0.8, seed=3,
                        spec_k=SPEC_K, **kw)
    for p in PROMPTS:
        eng.submit(p, max_new=6)
    done = eng.run_all()
    assert sorted(len(r.out) for r in done) == [6] * len(PROMPTS)
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.out)
    assert eng.spec_drafted > 0


def test_submit_counts_the_spec_headroom(models):
    _, cfg, _, tp = models
    for spec_k, ok in ((0, True), (SPEC_K, False)):
        eng = ServingEngine(tp, cfg, policy=FLOAT, slots=2, max_len=32,
                            dtype=torch.float32, spec_k=spec_k, device="cpu")
        if ok:
            eng.submit([1] * 20, max_new=12)
            continue
        with pytest.raises(SubmitRejected) as ei:
            eng.submit([1] * 20, max_new=12)
        assert ei.value.reason == "too_long" and "spec_k" in str(ei.value)
        eng.submit([1] * 20, max_new=8)
    with pytest.raises(ValueError, match="spec_k"):
        ServingEngine(tp, cfg, policy=FLOAT, slots=2, max_len=32,
                      spec_k=-1, device="cpu")


def test_serve_cli_spec_on_cpu(capsys):
    """The launcher derives the drafter from the master, serves
    speculatively and prints the accept rate."""
    from repro_torch.launch import serve
    serve.main(["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
                "--quant", "float", "--spec-k", "4", "--requests", "5",
                "--slots", "2", "--max-new", "6"])
    out = capsys.readouterr().out
    assert "5 requests, 30 tokens" in out and "spec accept rate" in out
