"""The port's dense model against the JAX package on the CPU, at
``reduced(qwen2-1.5b)`` (2 layers, d_model 64, vocab 128), from JAX-initialised
weights bridged as numpy.

The reduced model runs for forms w / q / qp x a float KV cache / int8: a
right-padded ``prefill(lengths=)`` and 8 ``decode_step``s fed the same
tokens, in fp32 with logits within 1e-4 and identical argmax; a bf16 run
(bf16 activations and cache, the serving dtype) holds 2e-2. The port runs both
its plain paths ('dequant'/'ref') and its kernel dispatch (which on CPU
tensors goes through the kernels' plain versions). The JAX side runs its
own XLA 'dequant'/'ref' paths."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import quant_dense as jqd
from repro.core.precision import FLOAT as JFLOAT, W3A8 as JW3A8
from repro.models import get_model as jget_model
from repro.models import layers as jlayers
from repro.models import api as japi

from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.core.precision import FLOAT, W3A8
from repro_torch.models import api, layers

JW3 = dataclasses.replace(JW3A8, act_bits=None)
W3 = dataclasses.replace(W3A8, act_bits=None)
TOL = dict(atol=1e-4, rtol=1e-4)

PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17], [40]]
BUCKET = 16


def _cfgs():
    jcfg = jreduced(jget_config("qwen2-1.5b"))
    cfg = reduced(get_config("qwen2-1.5b"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


@pytest.fixture(scope="module")
def master():
    jcfg, cfg = _cfgs()
    return jcfg, cfg, jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)


def _forms(master, form, act_bits=False):
    jcfg, cfg, jp = master
    if form == "w":
        jpol, pol = JFLOAT, FLOAT
    else:
        jpol, pol = (JW3A8, W3A8) if act_bits else (JW3, W3)
        jp = {"q": jqd.export_levels, "qp": jqd.export_container}[form](jp, jpol)
    return jcfg, cfg, jp, bridge.to_torch(jax.device_get(jp)), jpol, pol


def _np(x):
    return np.asarray(x, np.float32)


def _run_both(master, form, kv8, modes, act_bits=False, steps=8, tol=TOL,
              bf16=False):
    jcfg, cfg, jp, tp, jpol, pol = _forms(master, form, act_bits)
    toks = np.zeros((len(PROMPTS), BUCKET), np.int32)
    lens = np.array([len(p) for p in PROMPTS], np.int32)
    for i, p in enumerate(PROMPTS):
        toks[i, :len(p)] = p
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    jl, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                          policy=jpol, dtype=jdt, max_len=32,
                          lengths=jnp.asarray(lens), quantize_cache=kv8)
    mm, am = modes
    tl, tc = api.prefill(tp, {"tokens": torch.tensor(toks)}, cfg, policy=pol,
                         dtype=tdt, max_len=32,
                         lengths=torch.tensor(lens), quantize_cache=kv8,
                         matmul_mode=mm, attn_mode=am)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **tol)
    assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
    assert set(tc) == set(jc)
    for _ in range(steps):
        nxt = np.asarray(jl[:, -1].argmax(-1), np.int32)[:, None]
        jl, jc = japi.decode_step(jp, jc, jnp.asarray(nxt), jcfg, policy=jpol,
                                  dtype=jdt)
        tl, tc = api.decode_step(tp, tc, torch.tensor(nxt), cfg, policy=pol,
                                 dtype=tdt, matmul_mode=mm,
                                 attn_mode=am)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **tol)
        assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    return tc, jc


@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("form", ["w", "q", "qp"])
def test_reduced_model_matches_jax(master, form, kv8):
    tc, jc = _run_both(master, form, kv8, ("dequant", "ref"))
    if kv8:
        assert tc["k"].dtype == torch.int8


@pytest.mark.parametrize("kv8", [False, True])
def test_reduced_model_kernel_dispatch_matches_jax(master, kv8):
    """matmul_mode/attn_mode 'kernel' on CPU tensors: the ops wrappers run
    the kernels' plain versions, with the kernels' own masking rules."""
    _run_both(master, "qp", kv8, ("kernel", "kernel"))


def test_w3a8_act_quant_matches_jax(master):
    """The deployed W3A8 policy (8-bit per-row activation fake-quant)."""
    _run_both(master, "qp", False, ("dequant", "ref"), act_bits=True,
              steps=4, tol=dict(atol=1e-3, rtol=1e-3))


@pytest.mark.parametrize("kv8", [False, True])
def test_bf16_activations_and_cache_match_jax(master, kv8):
    """bf16 activations and a bf16 KV cache (the serving dtype), against
    the reference's bf16 run; bf16 rounds at the same places in both, so
    logits stay within 2e-2."""
    tc, _ = _run_both(master, "qp", kv8, ("dequant", "ref"), steps=4,
                      tol=dict(atol=2e-2, rtol=2e-2), bf16=True)
    assert tc["k"].dtype == (torch.int8 if kv8 else torch.bfloat16)


def test_layers_match_jax(master):
    from repro.models.attention import _guarded_softmax as jguarded
    from repro_torch.models.attention import _guarded_softmax
    jcfg, cfg, jp = master
    rng = np.random.default_rng(0)
    sc = rng.standard_normal((3, 7)).astype(np.float32)
    sc[1] = -1e30                                   # an all-masked row
    sc[2, :4] = -1e30
    got = _guarded_softmax(torch.tensor(sc)).numpy()
    np.testing.assert_allclose(got, _np(jguarded(jnp.asarray(sc))), **TOL)
    assert (got[1] == 0).all()
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        layers.rmsnorm({"scale": torch.tensor(scale)}, torch.tensor(x)).numpy(),
        _np(jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))),
        **TOL)
    xh = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 9, 11, 100, 3]], np.int32)
    np.testing.assert_allclose(
        layers.apply_rope(torch.tensor(xh), torch.tensor(pos),
                          layers.rope_freqs(16, 1e6)).numpy(),
        _np(jlayers.apply_rope(jnp.asarray(xh), jnp.asarray(pos),
                               jlayers.rope_freqs(16, 1e6))), **TOL)
    np.testing.assert_allclose(
        layers.act_fn("silu")(torch.tensor(x)).numpy(),
        _np(jlayers.act_fn("silu")(jnp.asarray(x))), **TOL)
    _, _, jq, tq, jpol, pol = _forms(master, "qp", act_bits=True)
    jmlp = jax.tree_util.tree_map(lambda a: a[0], jq["layers"]["mlp"])
    tmlp = {k: {n: t[0] for n, t in v.items()}
            for k, v in tq["layers"]["mlp"].items()}
    np.testing.assert_allclose(
        layers.mlp_apply(tmlp, torch.tensor(x), act="silu", policy=pol).numpy(),
        _np(jlayers.mlp_apply(jmlp, jnp.asarray(x), act="silu", policy=jpol)),
        atol=1e-3, rtol=1e-3)
    tok = np.array([[3, 9, 127], [0, 1, 2]], np.int32)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = layers.embed_lookup(tq["embed"], torch.tensor(tok), policy=pol,
                                  dtype=dt)
        ref = jlayers.embed_lookup(jq["embed"], jnp.asarray(tok), policy=jpol,
                                   dtype=jdt)
        np.testing.assert_array_equal(got.float().numpy(), _np(ref))
    h = rng.standard_normal((2, 1, 64)).astype(np.float32)
    np.testing.assert_allclose(
        layers.logits_readout(tq, torch.tensor(h), cfg, policy=pol).numpy(),
        _np(jlayers.logits_readout(jq, jnp.asarray(h), jcfg, policy=jpol)),
        **TOL)


def test_cache_primitives_match_jax(master):
    """init_cache / insert_prefill_many (out-of-range rows dropped) /
    free_slots give the reference's cache, bf16 and int8."""
    jcfg, cfg, _ = master
    rng = np.random.default_rng(2)
    for kv_bits in (None, 8):
        jc = japi.init_cache(jcfg, 4, 16, jnp.float32, per_slot_len=True,
                             kv_bits=kv_bits)
        tc = api.init_cache(cfg, 4, 16, torch.float32, per_slot_len=True,
                            kv_bits=kv_bits, device="cpu")
        src = {n: np.clip(rng.standard_normal((2, 3) + a.shape[2:]) * 50,
                          -120, 120).astype(np.dtype(a.dtype))
               for n, a in jc.items() if n != "len"}
        src["len"] = np.array([5, 9, 2], np.int32)
        slot_map = np.array([2, 4, 0], np.int32)          # 4 is out of range
        jc = jget_model(jcfg).insert_prefill_many(
            jc, jnp.asarray(slot_map), jax.tree_util.tree_map(jnp.asarray, src))
        tc = api.insert_prefill_many(cfg, tc, slot_map, bridge.to_torch(src))
        jc = japi.free_slots(jcfg, jc, jnp.asarray([0, 7], jnp.int32))
        tc = api.free_slots(cfg, tc, np.array([0, 7]))
        one = {n: a[:, 1:2] for n, a in src.items() if n != "len"}
        one["len"] = np.int32(11)
        jc = japi.insert_prefill(jcfg, jc, 3,
                                 jax.tree_util.tree_map(jnp.asarray, one))
        tc = api.insert_prefill(cfg, tc, 3, bridge.to_torch(one))
        for n in jc:
            np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]),
                                          err_msg=n)
        assert tc["len"].tolist() == [0, 0, 5, 11]
