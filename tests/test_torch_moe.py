"""The MoE family and the sliding-window KV ring in the port against the JAX
package on the CPU: ``reduced()`` phi3.5-moe (4 experts, top-2) and
mixtral-8x22b (4 experts, top-2, window 32), 2 layers, d_model 64, vocab
128, fp32, no activation quant, from JAX-initialised weights bridged as
numpy, compared with the reference's XLA ``dequant`` / ``ref`` paths
(interpret-mode Pallas at one tiny attention shape).

Tolerances: ``moe_apply`` output within 1e-5 x max|out| and the aux loss
within 1e-5 relative (fp32, the products sum in another order); attention
within 1e-5 x max|ref|; logits within 1e-5 x max|logit| with identical
argmax; export levels, packed words and bridged leaves bit for bit, deltas
within 1e-6 relative; engine tokens, admission and tick counts identical.
A routing choice that differs from JAX's is a fault unless the router
probabilities it stands between differ by under 1e-6 (none does here)."""
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
from repro.models import moe as jmoe
from repro.models.attention import prefill_attention as jprefill_attention
from repro.models.attention import (sliding_window_attention as
                                    jsliding_window_attention)
from repro.serving.engine import ServingEngine as JServingEngine

from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.core import quant_dense
from repro_torch.core.precision import FLOAT, W3A8
from repro_torch.core.quantizer import (QuantSpec, _optimal_delta_rows,
                                         max_level)
from repro_torch.core.treeutil import flatten_with_path
from repro_torch.models import api, moe, transformer
from repro_torch.models.attention import (prefill_attention,
                                          sliding_window_attention)
from repro_torch.models.layers import embed_init
from repro_torch.serving.engine import ServingEngine, generate

JW3 = dataclasses.replace(JW3A8, act_bits=None)
W3 = dataclasses.replace(W3A8, act_bits=None)
ARCHS = ["phi3.5-moe-42b-a6.6b", "mixtral-8x22b"]
TOL = 1e-5                      # x max|ref|: fp32, sums in another order
FLIP_MARGIN = 1e-6              # a routing flip stands only below this gap
# (prompt, max_new) of the engine runs; with max_len 64 the mixtral ring
# holds 32 positions: the 40-token prompt is admitted solo (past the
# bucket cap) and the rows decode past slot 31
ENGINE_REQS = [(list(range(1, 4)), 8), (list(range(7, 27)), 24),
               (list(range(30, 35)), 6), (list(range(41, 81)), 10),
               (list(range(90, 99)), 12)]


def _cfgs(arch):
    jcfg = jreduced(jget_config(arch))
    cfg = reduced(get_config(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _master(arch):
    jcfg, cfg = _cfgs(arch)
    jp = jax.jit(lambda k: jget_model(jcfg).init(k, jcfg))(
        jax.random.PRNGKey(0))
    return jcfg, cfg, jp


@functools.lru_cache(maxsize=None)
def _forms(arch, form):
    """(jcfg, cfg, JAX tree, port tree, JAX policy, port policy): the float
    master ("w", FLOAT) or its weight-only W3 export ("q" / "qp")."""
    jcfg, cfg, jp = _master(arch)
    if form == "w":
        jpol, pol = JFLOAT, FLOAT
    else:
        jpol, pol = JW3, W3
        export = {"q": jqd.export_levels, "qp": jqd.export_container}[form]
        jp = jax.jit(lambda p: export(p, jpol))(jp)
    return jcfg, cfg, jp, bridge.to_torch(jax.device_get(jp)), jpol, pol


def _close(got, ref, what, tol=TOL):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max(),
                               err_msg=what)


def _jax_routing(jlp, x, jcfg, jpol):
    """JAX's router probabilities and top-k experts for tokens ``x``,
    grouped as ``moe_apply`` groups them."""
    b, s, d = x.shape
    t = b * s
    g = min(jmoe.GROUP_SIZE, t)
    ng = t // g if t % g == 0 else 1
    xg = jnp.asarray(x).reshape(ng, -1, d)
    if "q" in jlp["router"]:
        logits = jqd.serve_apply(jlp["router"], xg, mode="dequant",
                                 out_dtype=jnp.float32)
    else:
        wr = jqd.effective_weight(jlp["router"], jpol, "router")
        logits = jnp.einsum("ngd,de->nge", xg, wr,
                            preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    top = jax.lax.top_k(probs, jcfg.experts_per_token)[1]
    return np.asarray(probs), np.asarray(top)


@pytest.mark.parametrize("shape", [(3, 7), (2, 512)],
                         ids=["one-group", "two-groups"])
@pytest.mark.parametrize("form", ["w", "q", "qp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, form, shape):
    """One layer's MoE block on seeded activations, in the dequant path and
    the kernel dispatch (the kernels' plain versions on CPU tensors):
    routing, output and aux loss against the reference's dequant path.
    (2, 512) routes 1024 tokens in two groups of 512; (3, 7) in one."""
    jcfg, cfg, jp, tp, jpol, pol = _forms(arch, form)
    jlp = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["moe"])
    lp = transformer._layer(tp["layers"]["moe"], 0)
    x = np.random.default_rng(3).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    jy, jaux = jmoe.moe_apply(jlp, jnp.asarray(x), jcfg, policy=jpol,
                              matmul_mode="dequant")
    jprobs, jtop = _jax_routing(jlp, x, jcfg, jpol)
    for mode in ("dequant", "kernel"):
        with moe.trace_routing() as trace:
            y, aux = moe.moe_apply(lp, torch.tensor(x), cfg, policy=pol,
                                   matmul_mode=mode)
        top = trace[0]["top_i"].numpy()
        assert len(trace) == 1 and top.shape == jtop.shape
        flips = np.argwhere((top != jtop).any(-1))
        for n, t in flips:
            # the probabilities at stake: JAX's of the expert each side
            # chose, at every choice where the two differ
            at = top[n, t] != jtop[n, t]
            margin = np.abs(jprobs[n, t, top[n, t][at]]
                            - jprobs[n, t, jtop[n, t][at]]).max()
            assert margin < FLIP_MARGIN, (
                f"routing flip at token {t} of group {n} with margin "
                f"{margin}")
        assert not len(flips)
        assert y.shape == x.shape and y.dtype == torch.float32
        _close(y, jy, f"{mode} out")
        np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL)


@pytest.mark.parametrize("form", ["q", "qp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_exports_match_jax(arch, form):
    """The port's export of the bridged master equals JAX's leaf for leaf:
    the (L, E, K, F) expert stacks stay int8 levels with one delta per
    layer and output channel (L, 1, 1, F) in both forms, the router 8-bit
    levels; the bridged JAX tree carries every level and word bit for
    bit."""
    jcfg, cfg, jp = _master(arch)
    *_, jx, tx, _, pol = _forms(arch, form)
    export = {"q": quant_dense.export_levels,
              "qp": quant_dense.export_container}[form]
    own = flatten_with_path(export(bridge.to_torch(jax.device_get(jp)), pol))
    ref = flatten_with_path(jax.device_get(jx))
    bridged = flatten_with_path(tx)
    assert sorted(own) == sorted(ref) == sorted(bridged)
    e, d, f, n = cfg.num_experts, cfg.d_model, cfg.d_ff, cfg.num_layers
    for name, shape in (("up", (n, e, d, f)), ("gate", (n, e, d, f)),
                        ("down", (n, e, f, d))):
        assert own[f"layers/moe/{name}/q"].shape == shape
        assert own[f"layers/moe/{name}/q"].dtype == torch.int8
        assert own[f"layers/moe/{name}/delta"].shape == (n, 1, 1, shape[-1])
    assert own["layers/moe/router/q"].shape == (n, d, e)
    for path, r in ref.items():
        for got in (own[path], bridged[path]):
            g = got.numpy()
            assert g.shape == r.shape and g.dtype == r.dtype, path
            if path.endswith("delta") and got is own[path]:
                np.testing.assert_allclose(g, r, rtol=1e-6, err_msg=path)
            elif "head" not in path:        # the head is stored K-major
                np.testing.assert_array_equal(g, r, err_msg=path)


def _whole_fit(leaf, spec):
    """Levels and deltas of every stacked index and column of ``leaf`` (one
    stacked dim) fitted at once."""
    levels = max_level(spec.bits)
    flat = leaf.reshape(leaf.shape[0], -1, leaf.shape[-1])
    rows = flat.transpose(1, 2).reshape(-1, flat.shape[1])
    d = _optimal_delta_rows(rows, levels, spec.iters).reshape(
        flat.shape[0], 1, -1)
    q = torch.clamp(torch.round(flat / torch.clamp(d, min=1e-12)),
                    -levels, levels).to(torch.int8)
    return (q.reshape(leaf.shape),
            d.reshape((leaf.shape[0],) + (1,) * (leaf.dim() - 2)
                      + (leaf.shape[-1],)))


@pytest.mark.parametrize("block", [1000, 96 * 40, 1 << 28])
def test_quantize_leaf_chunked_equals_whole_fit(monkeypatch, block):
    """``_quantize_leaf`` fits a stacked leaf by stacked index and block of
    output columns: levels and deltas bit for bit those of fitting the
    whole leaf at once (3-bit experts and an 8-bit 2-D stack), with
    several blocks a stacked index, one, and the export's own block."""
    monkeypatch.setattr(quant_dense, "_FIT_BLOCK", block)
    g = torch.Generator().manual_seed(5)
    for shape, bits in (((3, 4, 64, 100), 3), ((2, 96, 40), 8)):
        leaf = torch.randn(shape, generator=g) * 0.1
        spec = QuantSpec(bits=bits)
        whole = _whole_fit(leaf, spec)
        part = quant_dense._quantize_leaf(leaf, spec, 1)
        assert torch.equal(part[0], whole[0]), shape
        assert torch.equal(part[1], whole[1]), shape
        assert part[1].shape == whole[1].shape


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x22b"])
def test_init_fills_stacks_in_draw_order(arch):
    """``transformer.init`` fills preallocated (L, ...) stacks layer by
    layer: the numbers of drawing every layer and stacking them."""
    cfg = dataclasses.replace(reduced(get_config(arch), layers=3),
                              tie_embeddings=False)
    params = transformer.init(torch.Generator().manual_seed(2), cfg)
    g = torch.Generator().manual_seed(2)
    layers = [flatten_with_path(transformer._layer_init(
        g, cfg, torch.float32, None)) for _ in range(cfg.num_layers)]
    want = {"layers/" + path: torch.stack([lp[path] for lp in layers])
            for path in layers[0]}
    want["embed/w"] = embed_init(g, cfg.vocab_size, cfg.d_model)["w"]
    want["head/w"] = quant_dense.init(g, cfg.d_model, cfg.vocab_size,
                                      bias=False)["w"]
    flat = flatten_with_path(params)
    assert set(want) <= set(flat)
    for path, leaf in want.items():
        assert torch.equal(flat[path], leaf), path


def test_windowed_prefill_attention_matches_jax():
    """``prefill_attention(window=)`` in both modes (the kernel dispatch:
    attn_prefill's plain version with lo = max(t - window + 1, 0)) and
    ``sliding_window_attention`` against JAX's SWA scan, at the real query
    positions of right-padded rows; and at one tiny padded shape against
    the reference's interpret-mode Pallas kernel."""
    rng = np.random.default_rng(11)
    b, t, h, kvh, d, window = 2, 70, 4, 2, 16, 32
    q, k, v = (rng.standard_normal((b, t, n, d)).astype(np.float32)
               for n in (h, kvh, kvh))
    lens = np.array([70, 45], np.int32)
    ref = np.asarray(jsliding_window_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        chunk=24))
    tq, tk, tv = map(torch.tensor, (q, k, v))
    got = sliding_window_attention(tq, tk, tv, window=window, chunk=24)
    _close(got, ref, "sliding_window_attention")
    for mode in ("ref", "kernel"):
        out = prefill_attention(tq, tk, tv, lengths=torch.tensor(lens),
                                window=window, mode=mode)
        for row, n in enumerate(lens):
            _close(out[row, :n], ref[row, :n], f"{mode} row {row}")
    # the reference's Pallas kernel (interpret mode) at one tiny shape: a
    # full row and a right-padded one, as a bucketed admission pads them;
    # every query position, padded ones included, since both kernels bound
    # a padded query by its row's length
    q1, k1, v1 = q[:, :40], k[:, :40], v[:, :40]
    lens1 = np.array([40, 23], np.int32)
    jk = np.asarray(jprefill_attention(
        jnp.asarray(q1), jnp.asarray(k1), jnp.asarray(v1),
        lengths=jnp.asarray(lens1), window=8, mode="kernel", interpret=True))
    out = prefill_attention(*map(torch.tensor, (q1, k1, v1)),
                            lengths=torch.tensor(lens1), window=8,
                            mode="kernel")
    _close(out, jk, "kernel vs Pallas")


@functools.lru_cache(maxsize=None)
def _jax_ring_run(padded):
    """JAX's logits and cache lengths through mixtral's 32-slot ring:
    prefill (one unpadded 40-token prompt, rolled into the ring; or three
    right-padded prompts of a 32-token bucket), 36 decode steps past the
    window, then a 3-token verify_step."""
    jcfg, _, jp, _, jpol, _ = _forms("mixtral-8x22b", "qp")
    kw = dict(policy=jpol, dtype=jnp.float32)
    toks, lens = _ring_prompts(padded)
    prefill = jax.jit(lambda p, t, n: japi.prefill(
        p, {"tokens": t}, jcfg, max_len=96, lengths=n, **kw))
    decode = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, jcfg, **kw))
    jl, jc = prefill(jp, jnp.asarray(toks),
                     None if lens is None else jnp.asarray(lens))
    steps = [(np.asarray(jl), np.asarray(jc["len"]), None)]
    for _ in range(36):
        nxt = np.asarray(jl[:, -1].argmax(-1), np.int32)[:, None]
        jl, jc = decode(jp, jc, jnp.asarray(nxt))
        steps.append((np.asarray(jl), np.asarray(jc["len"]), nxt))
    ver = np.full((toks.shape[0], 3), 5, np.int32)
    jl, jc, _ = japi.verify_step(jp, jc, jnp.asarray(ver), jcfg, **kw)
    return steps + [(np.asarray(jl), np.asarray(jc["len"]), ver)]


def _ring_prompts(padded):
    if not padded:
        return np.arange(1, 41, dtype=np.int32)[None] % 127 + 1, None
    lens = np.array([3, 17, 30], np.int32)
    toks = np.zeros((3, 32), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = np.arange(n) * (i + 3) % 127 + 1
    return toks, lens


@pytest.mark.parametrize("padded,modes", [
    (False, ("dequant", "ref")), (True, ("dequant", "ref")),
    (False, ("kernel", "kernel"))], ids=["solo", "bucketed", "solo-kernel"])
def test_ring_prefill_decode_verify_match_jax(padded, modes):
    """The ring against JAX (max_len 96, window 32: a 32-slot ring): an
    unpadded prompt past the window keeps its last 32 positions rolled to
    their slots; right-padded prompts fill a bucket; then 36 decode steps
    write at pos % 32, wrapping the ring, and a verify_step writes at
    positions % 32. Logits at every step within 1e-5 x max|logit|.

    The kernel dispatch runs unpadded only: its attention masks a padded
    query to its row's length where the reference scan masks causally, and
    the padded positions' hidden states then enter the router and take
    expert capacity, so the two paths differ on padded MoE batches in the
    reference as in the port (the engines below serve the scan, as the
    reference's CPU engine does)."""
    _, cfg, _, tp, _, pol = _forms("mixtral-8x22b", "qp")
    ref = _jax_ring_run(padded)
    toks, lens = _ring_prompts(padded)
    mm, am = modes
    kw = dict(policy=pol, dtype=torch.float32, matmul_mode=mm, attn_mode=am)
    tl, tc = api.prefill(tp, {"tokens": torch.tensor(toks)}, cfg, max_len=96,
                         lengths=None if lens is None else torch.tensor(lens),
                         **kw)
    assert tc["k"].shape[2] == cfg.sliding_window == 32
    _close(tl, ref[0][0], "prefill")
    for i, (jl, jlen, nxt) in enumerate(ref[1:-1]):
        tl, tc = api.decode_step(tp, tc, torch.tensor(nxt), cfg, **kw)
        _close(tl, jl, f"decode {i}")
        assert (tl.argmax(-1).numpy() == jl.argmax(-1)).all()
        np.testing.assert_array_equal(tc["len"].numpy().reshape(-1),
                                      np.asarray(jlen).reshape(-1))
    jl, jlen, ver = ref[-1]
    tl, tc, _ = api.verify_step(tp, tc, torch.tensor(ver), cfg, **kw)
    _close(tl, jl, "verify")
    assert int(tc["len"].max()) > 32 + 36


def _staggered(eng, reqs=ENGINE_REQS):
    out = {}
    for p, n in reqs[:3]:                     # the first wave fills the slots
        out[int(eng.submit(p, max_new=n))] = tuple(p)
    eng.step(); eng.step()                    # decode in flight...
    for p, n in reqs[3:]:                     # ...the second wave queues
        out[int(eng.submit(p, max_new=n))] = tuple(p)
    return {out[r.uid]: list(r.out) for r in eng.run_all()}


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_token_identical_to_jax(arch):
    """The qp export served greedily by both engines, slots 3, max_len 64,
    staggered admission: the same tokens for every request, the same
    admission rounds and ticks. Capacity couples rows, so the dummy rows of
    each bucketed round and the held tokens of idle slots must enter the
    router as they do in the reference. For mixtral (32-slot ring) the
    40-token prompt is admitted solo and rows decode past the ring."""
    jcfg, cfg, jp, tp, jpol, pol = _forms(arch, "qp")
    kw = dict(slots=3, max_len=64)
    jeng = JServingEngine(jp, jcfg, policy=jpol, dtype=jnp.float32, **kw)
    eng = ServingEngine(tp, cfg, policy=pol, dtype=torch.float32,
                        device="cpu", **kw)
    solo, admit_solo = [], eng._admit_solo
    eng._admit_solo = lambda slot, req: (solo.append(len(req.admit_prompt)),
                                         admit_solo(slot, req))
    ref, got = _staggered(jeng), _staggered(eng)
    assert got == ref and len(got) == len(ENGINE_REQS)
    assert (eng.prefill_calls, eng.decode_calls) == \
        (jeng.prefill_calls, jeng.decode_calls)
    # mixtral: the 40-token prompt is a round of its own, past the cap
    assert solo == ([40] if cfg.sliding_window else [])


def test_spec_engine_on_a_window_matches_jax():
    """Self-speculative serving of reduced mixtral with max_len <= window
    (spec_k 2, the float master verifying its qp drafter from
    ``api.draft_of``, bridged from JAX's): the same tokens and accept
    counts as the JAX engine; a max_len past the window raises in the
    engine and in ``generate``, as the reference's ``_no_ring_wrap``."""
    jcfg, cfg, jp = _master("mixtral-8x22b")
    tp = bridge.to_torch(jax.device_get(jp))
    jdcfg, jdp = japi.draft_of(jcfg, jp)
    dcfg, dp = api.draft_of(cfg, tp)
    assert sorted(flatten_with_path(dp)) == \
        sorted(flatten_with_path(jax.device_get(jdp)))
    kw = dict(slots=3, max_len=32, spec_k=2)
    reqs = [(p[:8], 6) for p, _ in ENGINE_REQS]
    jeng = JServingEngine(jp, jcfg, policy=JFLOAT, dtype=jnp.float32,
                          draft_params=jdp, draft_cfg=jdcfg, **kw)
    eng = ServingEngine(tp, cfg, policy=FLOAT, dtype=torch.float32,
                        draft_params=bridge.to_torch(jax.device_get(jdp)),
                        draft_cfg=dcfg, device="cpu", **kw)
    assert _staggered(eng, reqs) == _staggered(jeng, reqs)
    assert (eng.spec_drafted, eng.spec_accepted) == \
        (jeng.spec_drafted, jeng.spec_accepted)
    with pytest.raises(ValueError, match="sliding_window"):
        ServingEngine(tp, cfg, policy=FLOAT, slots=2, max_len=64, spec_k=2,
                      device="cpu")
    with pytest.raises(ValueError, match="sliding_window"):
        generate(tp, torch.ones((1, 30), dtype=torch.int32), cfg,
                 policy=FLOAT, max_new_tokens=4, spec_k=2, device="cpu")
