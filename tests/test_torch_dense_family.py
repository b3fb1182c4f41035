"""The rest of the dense family in the port against the JAX package on the
CPU, from JAX-initialised weights bridged as numpy, fp32, no activation
quant:

- stablelm-3b at ``reduced(cfg, d_model=320)``: 4 heads of head_dim 80,
  MHA, untied 8-bit head;
- qwen2.5-14b reduced to 10 query heads over 2 KV heads (G = 5), head_dim
  16, QKV bias, untied head;
- qwen3-32b reduced to 4 query heads over 2 KV heads, qk-norm, its q_norm
  and k_norm scales set to seeded random values before bridging (so a
  misplaced scale shows), untied head;
- qwen2-1.5b reduced with ``tie_embeddings=False``: the untied head on the
  architecture the port served first.

Each runs forms w / q / qp with a float and an int8 KV cache through the
plain paths, and the qp form through the kernel dispatch (the kernels'
plain versions on CPU tensors): prefill + 6 decode steps, then one
``verify_step`` of 5 tokens. Logits within 1e-5 x max|logit| of JAX's with
identical argmax. With an int8 KV cache a K or V value that lands within
an ulp of a rounding tie may take the neighbouring level on one side (the
two sum the projections in another order): the levels must agree within
1, and where one differs the logits are held to 2e-3 x max|logit|, the
reach of one level of one cached entry (1/127 of it).

Greedy ``ServingEngine`` tokens equal the JAX engine's (each case with a
float KV cache, stablelm-3b also with int8), and for qwen3-32b the
self-speculative engine's (spec_k 4, the qp drafter from ``api.draft_of``
carrying the qk-norm scales)."""
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
from repro_torch.core import quant_dense
from repro_torch.core.precision import FLOAT, W3A8
from repro_torch.core.treeutil import flatten_with_path
from repro_torch.kernels.qmatmul import kernel as qmm_k
from repro_torch.models import api
from repro_torch.serving.engine import ServingEngine

JW3 = dataclasses.replace(JW3A8, act_bits=None)
W3 = dataclasses.replace(W3A8, act_bits=None)
TOL = 1e-5                      # x max|logit|: fp32, sums in another order
TIE_TOL = 2e-3                  # x max|logit|: an int8 KV level moved by a tie
PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17], [40]]
VERIFY = np.array([[5, 9, 2, 77, 3], [1, 1, 1, 1, 1], [100, 4, 8, 15, 16]],
                  np.int32)
ENGINE_PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11],
                  [20, 21, 22, 23, 24, 25, 26, 27, 28], [30, 31, 32, 33],
                  [40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51]]
CASES = {
    "stablelm-3b": (dict(d_model=320), {}),
    "qwen2.5-14b": (dict(d_model=160),
                    dict(num_heads=10, num_kv_heads=2, head_dim=16)),
    "qwen3-32b": ({}, dict(num_kv_heads=2)),
    "qwen2-1.5b-untied": ({}, dict(tie_embeddings=False)),
}


def _cfgs(case):
    arch = case.replace("-untied", "")
    size, over = CASES[case]
    jcfg = dataclasses.replace(jreduced(jget_config(arch), **size), **over)
    cfg = dataclasses.replace(reduced(get_config(arch), **size), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


_MASTERS = {}


def _master(case):
    """(jcfg, cfg, JAX master) with non-unit qk-norm scales, built once."""
    if case not in _MASTERS:
        jcfg, cfg = _cfgs(case)
        jp = jax.jit(lambda k: jget_model(jcfg).init(k, jcfg))(
            jax.random.PRNGKey(0))
        if cfg.qk_norm:
            rng = np.random.default_rng(7)
            attn = dict(jp["layers"]["attn"])
            for name in ("q_norm", "k_norm"):
                shape = attn[name]["scale"].shape
                attn[name] = {"scale": jnp.asarray(
                    rng.uniform(0.5, 1.5, shape).astype(np.float32))}
            jp = {**jp, "layers": {**jp["layers"], "attn": attn}}
        _MASTERS[case] = (jcfg, cfg, jp)
    return _MASTERS[case]


@functools.lru_cache(maxsize=None)
def _forms(case, form):
    jcfg, cfg, jp = _master(case)
    if form == "w":
        jpol, pol = JFLOAT, FLOAT
    else:
        jpol, pol = JW3, W3
        export = {"q": jqd.export_levels, "qp": jqd.export_container}[form]
        jp = jax.jit(lambda p: export(p, jpol))(jp)
    return jcfg, cfg, jp, bridge.to_torch(jax.device_get(jp)), jpol, pol


@functools.lru_cache(maxsize=None)
def _jax_run(case, form, kv8):
    """JAX's logits and caches: after prefill, after each of the 6 decode
    steps and after the verify step (shared by the plain and the kernel
    dispatch runs of the port). Jitted, as the reference serves: XLA may
    move a result by an ulp, well inside the tolerance."""
    jcfg, _, jp, _, jpol, _ = _forms(case, form)
    kw = dict(policy=jpol, dtype=jnp.float32)
    prefill = jax.jit(lambda p, t, n: japi.prefill(
        p, {"tokens": t}, jcfg, max_len=32, lengths=n, quantize_cache=kv8,
        **kw))
    decode = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, jcfg, **kw))
    verify = jax.jit(lambda p, c, t: japi.verify_step(p, c, t, jcfg, **kw))
    toks, lens = _prompts()
    jl, jc = prefill(jp, jnp.asarray(toks), jnp.asarray(lens))
    steps = [(jl, jc)]
    for _ in range(6):
        nxt = np.asarray(jl[:, -1].argmax(-1), np.int32)[:, None]
        jl, jc = decode(jp, jc, jnp.asarray(nxt))
        steps.append((jl, jc))
    jl, jc, _ = verify(jp, jc, jnp.asarray(VERIFY))
    return steps + [(jl, jc)]


def _prompts():
    toks = np.zeros((len(PROMPTS), 16), np.int32)
    for i, p in enumerate(PROMPTS):
        toks[i, :len(p)] = p
    return toks, np.array([len(p) for p in PROMPTS], np.int32)


def _level_gap(tc, jc):
    """The largest difference of the int8 K/V levels at the positions each
    row holds (0 for a float cache; past a row's length the padded
    prefill rows are never read, and the kernel path leaves other values
    there); it must be at most one level."""
    if "k_scale" not in jc:
        return 0
    lens = np.asarray(jc["len"]).reshape(-1)
    held = torch.arange(jc["k"].shape[2])[None, :] < torch.tensor(lens)[:, None]
    gap = max(int(((tc[n].int() - torch.tensor(np.asarray(jc[n])).int())
                   .abs().amax((-2, -1)) * held).max()) for n in ("k", "v"))
    assert gap <= 1, gap
    return gap


def _close(tl, jl, what, tie=False):
    ref = np.asarray(jl, np.float32)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(tl.numpy(), ref, rtol=0, err_msg=what,
                               atol=(TIE_TOL if tie else TOL) * scale)
    assert (tl.argmax(-1).numpy() == ref.argmax(-1)).all(), what


@pytest.mark.parametrize("form,modes", [("w", ("dequant", "ref")),
                                        ("q", ("dequant", "ref")),
                                        ("qp", ("dequant", "ref")),
                                        ("qp", ("kernel", "kernel"))])
@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_jax(case, form, modes, kv8):
    """Prefill (right-padded, per-row lengths), 6 decode steps and a
    5-token verify_step against the live cache, logits against JAX's."""
    _, cfg, _, tp, _, pol = _forms(case, form)
    ref = _jax_run(case, form, kv8)
    toks, lens = _prompts()
    mm, am = modes
    kw = dict(dtype=torch.float32, matmul_mode=mm, attn_mode=am)
    tl, tc = api.prefill(tp, {"tokens": torch.tensor(toks)}, cfg, policy=pol,
                         max_len=32, lengths=torch.tensor(lens),
                         quantize_cache=kv8, **kw)
    _close(tl, ref[0][0], "prefill")
    for i in range(6):
        nxt = np.asarray(ref[i][0][:, -1].argmax(-1), np.int32)[:, None]
        tl, tc = api.decode_step(tp, tc, torch.tensor(nxt), cfg, policy=pol,
                                 **kw)
        jl, jc = ref[i + 1]
        _close(tl, jl, f"decode {i}", tie=_level_gap(tc, jc) > 0)
    tl, tc, traj = api.verify_step(tp, tc, torch.tensor(VERIFY), cfg,
                                   policy=pol, **kw)
    jl, jc = ref[-1]
    assert traj is None and tl.shape == (3, 5, cfg.vocab_size)
    _close(tl, jl, "verify", tie=_level_gap(tc, jc) > 0)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def _staggered(eng, max_new=6):
    out = {}
    for p in ENGINE_PROMPTS[:3]:                 # first wave fills all slots
        out[int(eng.submit(p, max_new=max_new))] = tuple(p)
    eng.step(); eng.step()                       # decode in flight...
    for p in ENGINE_PROMPTS[3:]:                 # ...second wave queues up
        out[int(eng.submit(p, max_new=max_new))] = tuple(p)
    return {out[r.uid]: list(r.out) for r in eng.run_all()}


@pytest.mark.parametrize("case,kv_bits", [(c, None) for c in CASES]
                         + [("stablelm-3b", 8)])
def test_engine_token_identical_to_jax(case, kv_bits):
    """The qp export served greedily by both engines under staggered
    mixed-length admission: the same tokens for every request (an int8 KV
    cache at stablelm-3b's head_dim 80; the engine's int8 path is
    otherwise the one tests/test_torch_engine.py holds)."""
    jcfg, cfg, jp, tp, jpol, pol = _forms(case, "qp")
    kw = dict(slots=3, max_len=32, kv_bits=kv_bits)
    jeng = JServingEngine(jp, jcfg, policy=jpol, dtype=jnp.float32, **kw)
    eng = ServingEngine(tp, cfg, policy=pol, dtype=torch.float32,
                        device="cpu", **kw)
    ref, got = _staggered(jeng), _staggered(eng)
    assert got == ref and len(got) == len(ENGINE_PROMPTS)
    assert eng.decode_calls == jeng.decode_calls


@pytest.mark.parametrize("case", ["qwen3-32b"])
def test_spec_engine_token_identical_to_jax(case):
    """Self-speculative serving: the float master verifies the drafts of
    its qp export. ``api.draft_of`` gives JAX's tree and carries the
    qk-norm scales unquantized, as the master holds them; with JAX's
    drafter bridged (so a delta fit that ends an ulp apart cannot move a
    level) both engines serve the same tokens with the same accept
    counts."""
    jcfg, cfg, jp = _master(case)
    tp = bridge.to_torch(jax.device_get(jp))
    jdcfg, jdp = japi.draft_of(jcfg, jp)
    dcfg, dp = api.draft_of(cfg, tp)
    assert sorted(flatten_with_path(dp)) == \
        sorted(flatten_with_path(jax.device_get(jdp)))
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            got = dp["layers"]["attn"][name]["scale"]
            assert got.dtype == torch.float32
            assert torch.equal(got, tp["layers"]["attn"][name]["scale"])
            assert not torch.all(got == 1.0)
    kw = dict(slots=3, max_len=40, spec_k=4)
    jeng = JServingEngine(jp, jcfg, policy=JFLOAT, dtype=jnp.float32,
                          draft_params=jdp, draft_cfg=jdcfg, **kw)
    eng = ServingEngine(tp, cfg, policy=FLOAT, dtype=torch.float32,
                        draft_params=bridge.to_torch(jax.device_get(jdp)),
                        draft_cfg=dcfg, device="cpu", **kw)
    assert _staggered(eng, 8) == _staggered(jeng, 8)
    assert (eng.spec_drafted, eng.spec_accepted) == \
        (jeng.spec_drafted, jeng.spec_accepted)


@pytest.mark.parametrize("case", list(CASES))
def test_container_head_is_k_major(case):
    """The qp export stores the untied head's (K, N) levels K-contiguous
    (the bridged JAX export and the port's own alike), so qmatmul plans
    k_lanes for it; the q form keeps a row-major head (n_lanes for N > 64).
    Values and shapes are JAX's."""
    jcfg, cfg, jp = _master(case)
    for form, layout in (("qp", "k_lanes"), ("q", "n_lanes")):
        *_, jx, tx, _, pol = _forms(case, form)
        export = {"qp": quant_dense.export_container,
                  "q": quant_dense.export_levels}[form]
        own = export(bridge.to_torch(jax.device_get(jp)), pol)
        for tree in (tx, own):
            q = tree["head"]["q"]
            np.testing.assert_array_equal(q.numpy(),
                                          np.asarray(jx["head"]["q"]))
            assert qmm_k.plan(8, *q.shape, *q.stride(),
                              torch.bfloat16).layout == layout
