"""The paper's path in the port against the JAX package on the CPU: the PLAN
sigmoid (plain version, forward and gradient), STE fake-quant, the
quantizer and the MLP's packed export, the DNN forward in every weight
form, the synthetic data, loss, SGD, one CD-1 step and short training runs.

Tolerances, with their reasons:
- bit-identical: the PLAN sigmoid and its gradient (power-of-two slopes make
  every product exact), ``quantize`` levels, the packed words, the data,
  every STE gradient and the fake-quant forwards against the reference run
  op by op (the same operations in the same order; under ``jax.jit`` XLA
  rewrites the divisions and moves them by up to 2 ulp);
- a refit delta within rtol 1e-6 (its 25-iteration fit sums in another
  order than XLA does);
- DNN logits within 1e-5 x max|logit| (matmul summation order, exact
  sigmoid implementations differ by ulps);
- training runs as stated at each test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.core import qat as jqat
from repro.core import quant_dense as jqd
from repro.core import quantizer as jqz
from repro.core.precision import FLOAT as JFLOAT
from repro.core.precision import W3A8 as JW3A8
from repro.data import synthetic as jsyn
from repro.kernels.sigmoid_pw import ref as jsig
from repro.kernels.sigmoid_pw.kernel import sigmoid_pw_pallas
from repro.models import dnn as jdnn
from repro.paper import pipeline as jpipe
from repro.paper import rbm as jrbm
from repro.training import losses as jlosses

from repro_torch import bridge, optim
from repro_torch.core import qat, quant_dense
from repro_torch.core import quantizer as qz
from repro_torch.core.precision import FLOAT, W3A8
from repro_torch.core.treeutil import flatten_with_path
from repro_torch.data import synthetic
from repro_torch.kernels.sigmoid_pw import ops as sig_ops
from repro_torch.kernels.sigmoid_pw import ref as sig_ref
from repro_torch.models import dnn
from repro_torch.paper import pipeline, rbm
from repro_torch.training import losses

SPECIAL = [0.0, -0.0, 1.0, -1.0, 2.375, -2.375, 5.0, -5.0, 0.99999994,
           -1.0000001, 2.3749998, 4.9999995, -5.0000005, 1e-40, -1e-40,
           np.inf, -np.inf, np.nan, -np.nan]
DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def _sig_input(dtype, shape=None, seed=0):
    if shape is None:
        x = np.concatenate([np.linspace(-8, 8, 1000, dtype=np.float32),
                            np.array(SPECIAL, np.float32)])
    else:
        x = np.random.default_rng(seed).standard_normal(shape) * 4
    return np.asarray(x, np.float32).astype(DTYPES[dtype])


def _t(a):
    return bridge.to_torch(np.asarray(a))


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _assert_same_bits(got, ref):
    """Identical bit patterns, except that any NaN matches any NaN."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    nan_g, nan_r = np.isnan(got.astype(np.float32)), np.isnan(ref.astype(np.float32))
    np.testing.assert_array_equal(nan_g, nan_r)
    ui = np.uint32 if got.dtype == np.float32 else np.uint16
    np.testing.assert_array_equal(got.view(ui)[~nan_g], ref.view(ui)[~nan_r])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these small eager ops only lose to thread
    hand-offs when the suite's workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the PLAN sigmoid -----------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [None, (7,), (3, 5), (2, 3, 129)])
def test_sigmoid_pw_forward_bit_identical(dtype, shape):
    x = _sig_input(dtype, shape)
    n0 = sig_ref.calls
    got = _np(sig_ops.sigmoid_pw(_t(x)))        # CPU tensor: the plain version
    assert sig_ref.calls == n0 + 1
    _assert_same_bits(got, np.asarray(jsig.sigmoid_pw(jnp.asarray(x))))
    _assert_same_bits(got, np.asarray(sigmoid_pw_pallas(jnp.asarray(x),
                                                        interpret=True)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_sigmoid_pw_gradient_is_jax_gradient(dtype):
    x = _sig_input(dtype)
    r = np.random.default_rng(1).standard_normal(x.shape).astype(DTYPES[dtype])
    ref = np.asarray(jax.grad(
        lambda v: jnp.sum(jsig.sigmoid_pw(v) * jnp.asarray(r)))(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    (sig_ops.sigmoid_pw(xt) * _t(r)).sum().backward()
    keep = ~np.isnan(x.astype(np.float32))
    _assert_same_bits(_np(xt.grad)[keep], ref[keep])
    # JAX's abs passes +1 at 0 and -0.0; the slopes follow the >= breaks
    g1 = np.asarray(jax.grad(lambda v: jnp.sum(jsig.sigmoid_pw(v)))(
        jnp.asarray(x)))
    xt.grad = None
    sig_ops.sigmoid_pw(xt).sum().backward()
    _assert_same_bits(_np(xt.grad)[keep], g1[keep])
    at = {v: float(_np(xt.grad)[i].astype(np.float32))
          for i, v in enumerate(x.astype(np.float32).tolist()) if v in
          (0.0, 5.0, -5.0, 2.375, 1.0)}
    assert at == {0.0: 0.25, 5.0: 0.0, -5.0: 0.0, 2.375: 0.03125, 1.0: 0.125}
    assert float(_np(xt.grad)[1000 + SPECIAL.index(-0.0)]) == 0.25


def test_sigmoid_pw_raises_off_cpu_and_cuda():
    with pytest.raises(ValueError, match="no path for device"):
        sig_ops.sigmoid_pw(torch.empty(3, device="meta"))


# --- STE fake-quant ------------------------------------------------------------

def _act_input(shape, signed, seed=3):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 3
    if not signed:
        x = np.abs(x)
        x.reshape(-1)[::7] = 0.0                # ties at the lower bound
    return x


@pytest.mark.parametrize("shape", [(5, 33), (3, 4, 16), (40,)])
@pytest.mark.parametrize("signed", [True, False])
def test_fake_quant_act_forward_and_gradient(shape, signed):
    x = _act_input(shape, signed)
    r = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    fq = lambda v: jqat.fake_quant_act(v, 8, signed)
    ref = np.asarray(fq(jnp.asarray(x)))
    jg = np.asarray(jax.grad(lambda v: jnp.sum(fq(v) * jnp.asarray(r)))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = qat.fake_quant_act(xt, 8, signed)
    (got * torch.from_numpy(r)).sum().backward()
    _assert_same_bits(got.detach().numpy(), ref)
    np.testing.assert_array_equal(xt.grad.numpy(), jg)
    # the row's absmax sits on a clip bound: half the gradient passes
    i = np.argmax(np.abs(x).reshape(len(x), -1) if x.ndim > 1 else np.abs(x),
                  axis=-1)
    at = lambda a: (a.reshape(len(x), -1)[np.arange(len(x)), i]
                    if x.ndim > 1 else a[i])
    np.testing.assert_allclose(at(xt.grad.numpy()), 0.5 * at(r), rtol=1e-6)


@pytest.mark.parametrize("per_channel", [None, -1])
@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("bits", [3, 8])
def test_fake_quant_forward_and_gradient(per_channel, fixed, bits):
    """A fixed delta: forward and gradient identical. A refit
    delta (``delta=None``): delta within rtol 1e-6, the same levels; the
    gradient, (g * d) / d through the clip, then depends on d's last bits,
    so it is held identical to JAX's given the port's refit delta, and
    identical to the port's own gradient with that delta frozen."""
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((48, 24)).astype(np.float32)
    r = rng.standard_normal(w.shape).astype(np.float32)
    jspec = jqz.QuantSpec(bits=bits, per_channel=per_channel)
    spec = qz.QuantSpec(bits=bits, per_channel=per_channel)
    jd = jqz.optimal_uniform_delta(jnp.asarray(w), jspec)
    d = qz.optimal_uniform_delta(torch.from_numpy(w), spec)

    def jgrad(delta):
        return np.asarray(jax.grad(lambda v: jnp.sum(
            jqat.fake_quant(v, jspec, delta) * jnp.asarray(r)))(jnp.asarray(w)))

    def grad(delta):
        wt = torch.from_numpy(w).requires_grad_(True)
        out = qat.fake_quant(wt, spec, delta)
        (out * torch.from_numpy(r)).sum().backward()
        return out.detach().numpy(), wt.grad.numpy()

    ref = np.asarray(jqat.fake_quant(jnp.asarray(w), jspec,
                                     jd if fixed else None))
    if fixed:
        got, g = grad(torch.from_numpy(np.array(jd)))
        _assert_same_bits(got, ref)
        np.testing.assert_array_equal(g, jgrad(jd))
    else:
        got, g = grad(None)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(
            qz.quantize_levels(torch.from_numpy(w), d, spec).numpy(),
            np.asarray(jqz.quantize_levels(jnp.asarray(w), jd, jspec)))
        np.testing.assert_array_equal(g, jgrad(jnp.asarray(d.numpy())))
        np.testing.assert_array_equal(g, grad(d)[1])
    tie = np.isclose(g, 0.5 * r, rtol=1e-6) & (np.abs(g) > 0)
    assert tie.any()                      # weights rounding to +-M: half


# --- quantizer and the MLP's packed export ------------------------------------------

@pytest.mark.parametrize("per_channel", [None, -1])
def test_quantize_and_dequantize(per_channel):
    w = np.random.default_rng(9).standard_normal((64, 30)).astype(np.float32)
    jspec = jqz.QuantSpec(bits=3, per_channel=per_channel)
    spec = qz.QuantSpec(bits=3, per_channel=per_channel)
    jq, jd = jqz.quantize(jnp.asarray(w), jspec)
    q, d = qz.quantize(torch.from_numpy(w), spec)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)
    np.testing.assert_array_equal(
        qz.dequantize(q, torch.from_numpy(np.array(jd)), spec).numpy(),
        np.asarray(jqz.dequantize(jq, jd, jspec)))


HIDDEN = (64, 64, 64)


@pytest.fixture(scope="module")
def jtree():
    return jax.device_get(jax.jit(lambda k: jdnn.init(k, 784, HIDDEN, 10))(
        jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def tree(jtree):
    return bridge.to_torch(jtree)


@pytest.fixture(scope="module")
def xs():
    return synthetic.digit_task(n_train=100, n_test=100).test[0][:32]


def test_fit_deltas(jtree, tree):
    ref = flatten_with_path(jax.device_get(jqd.fit_deltas(jtree, JW3A8)))
    got = flatten_with_path(quant_dense.fit_deltas(tree, W3A8))
    assert sorted(ref) == sorted(got) == ["fc0/w", "fc1/w", "fc2/w", "head/w"]
    for p in ref:
        np.testing.assert_allclose(got[p].numpy(), ref[p], rtol=1e-6)


def test_export_packed_words_and_packed_apply(jtree, tree, xs):
    ref = jax.device_get(jqd.export_packed(jtree, JW3A8))
    got = quant_dense.export_packed(tree, W3A8)
    fr, fg = flatten_with_path(ref), flatten_with_path(got)
    assert sorted(fr) == sorted(fg)
    for p, r in fr.items():
        g = fg[p].numpy()
        assert g.dtype == r.dtype and g.shape == r.shape, p
        if p.endswith("delta"):
            np.testing.assert_allclose(g, r, rtol=1e-6, err_msg=p)
        else:
            np.testing.assert_array_equal(g, r, err_msg=p)
    assert got["head"]["w"]["q"].shape == (-(-64 // 4), 10)   # 4 fields/word
    assert int(got["fc1"]["w"]["bits"]) == 3
    h = np.random.default_rng(2).random((9, 64)).astype(np.float32)
    for name, x in (("fc0", xs), ("fc1", h), ("head", h)):
        want = np.asarray(jqd.packed_apply(ref[name]["w"], jnp.asarray(x),
                                           use_kernel=False))
        out = quant_dense.packed_apply(got[name]["w"], torch.from_numpy(x),
                                       use_kernel=False)
        # within 1e-6 x max|out|: K = 784 fp32 sums in another order
        np.testing.assert_allclose(out.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    assert quant_dense.is_serve_form(quant_dense.export_container(tree, W3A8))
    assert not quant_dense.is_serve_form(tree)


# --- the DNN forward ---------------------------------------------------------------

_FWD = [("float", None, "exact"), ("float", None, "pw"),
        ("fake", "refit", "exact"), ("fake", "refit", "pw"),
        ("fake", "frozen", "exact"), ("fake", "frozen", "pw"),
        ("container", None, "pw")]


@pytest.mark.parametrize("form,deltas,sig", _FWD)
def test_dnn_forward_matches_jax(jtree, tree, xs, form, deltas, sig):
    jpol, pol = (JFLOAT, FLOAT) if form == "float" else (JW3A8, W3A8)
    jp, p, jd, d = jtree, tree, None, None
    if form == "container":
        jpol = dataclasses.replace(JW3A8, act_bits=None)
        pol = dataclasses.replace(W3A8, act_bits=None)
        jp = jax.device_get(jqd.export_container(jtree, JW3A8))
        p = quant_dense.export_container(tree, W3A8)
    if deltas == "frozen":
        jd = jqd.fit_deltas(jtree, JW3A8)
        d = bridge.to_torch(jax.device_get(jd))
    ref = np.asarray(jax.jit(lambda p_, x_, d_: jdnn.forward(
        p_, x_, policy=jpol, deltas=d_, sigmoid_mode=sig))(jp, jnp.asarray(xs), jd))
    got = dnn.forward(p, torch.from_numpy(xs), policy=pol, deltas=d,
                      sigmoid_mode=sig).numpy()
    assert got.shape == ref.shape == (32, 10)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    assert dnn.num_params(p) == jdnn.num_params(jp)


# --- data, loss, SGD, CD-1 ------------------------------------------------------------

@pytest.mark.parametrize("task", ["digit_task", "phoneme_task"])
def test_synthetic_tasks_identical(task):
    jt = getattr(jsyn, task)(seed=0)
    t = getattr(synthetic, task)(seed=0)
    for split in ("train", "test"):
        for a, b in zip(getattr(jt, split), getattr(t, split)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for (jx, jy), (x, y) in zip(jt.batches("train", 100, seed=3),
                                t.batches("train", 100, seed=3)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        break


def test_softmax_xent_and_accuracy():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((4, 6, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (4, 6)).astype(np.int32)
    labels[0, :3] = losses.IGNORE
    labels[2, 5] = jlosses.IGNORE
    jl, jlab = jnp.asarray(logits), jnp.asarray(labels)
    lt, labt = torch.from_numpy(logits), torch.from_numpy(labels)
    np.testing.assert_allclose(float(losses.softmax_xent(lt, labt)),
                               float(jax.jit(jlosses.softmax_xent)(jl, jlab)),
                               rtol=1e-6)
    assert float(losses.accuracy(lt, labt)) == \
        float(jax.jit(jlosses.accuracy)(jl, jlab))
    ignored = np.full((2, 3), losses.IGNORE, np.int32)
    assert float(losses.softmax_xent(lt[:2, :3], torch.from_numpy(ignored))) == 0.0


def test_sgd_update_matches_jax():
    rng = np.random.default_rng(8)
    mk = lambda: {"a": {"w": rng.standard_normal((5, 3)).astype(np.float32)},
                  "b": rng.standard_normal(4).astype(np.float32)}
    params, grads, mu = mk(), mk(), mk()
    jopt, opt = joptim.sgd(momentum=0.9), optim.sgd(momentum=0.9)
    jupd, jstate = jopt.update(grads, {"mu": mu}, params, jnp.asarray(0.1, jnp.float32))
    jnew = jax.device_get(joptim.apply_updates(params, jupd))
    t = bridge.to_torch
    upd, state = opt.update(t(grads), {"mu": t(mu)}, t(params), 0.1)
    new = optim.apply_updates(t(params), upd)
    for p, r in flatten_with_path(jnew).items():
        np.testing.assert_array_equal(flatten_with_path(new)[p].numpy(), r)
    for p, r in flatten_with_path(jax.device_get(jstate)).items():
        np.testing.assert_array_equal(flatten_with_path(state)[p].numpy(), r)
    assert flatten_with_path(opt.init(t(params)))["mu/b"].abs().sum() == 0


def test_cd1_step_fed_jax_draw():
    rng = np.random.default_rng(10)
    w = (rng.standard_normal((20, 12)) * 0.3).astype(np.float32)
    vb, hb = (rng.standard_normal(20) * 0.1).astype(np.float32), \
        (rng.standard_normal(12) * 0.1).astype(np.float32)
    mw, mvb, mhb = (rng.standard_normal(s).astype(np.float32) * 0.01
                    for s in ((20, 12), (20,), (12,)))
    v0 = rng.random((8, 20)).astype(np.float32)
    k2 = jax.random.PRNGKey(5)
    args = [w, vb, hb, mw, mvb, mhb, v0]
    ref = jax.device_get(jrbm._cd1_step(*map(jnp.asarray, args), k2,
                                        jnp.asarray(0.01, jnp.float32), 0.9,
                                        False))
    u = np.asarray(jax.random.uniform(jax.random.split(k2)[0], (8, 12)))
    got = rbm._cd1_step(*map(torch.from_numpy, args), torch.from_numpy(u.copy()),
                        0.01, 0.9, False)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-6)


def test_three_step_pipeline_order():
    """``three_step_pipeline`` hands each step's artifacts to the next, as
    JAX's does."""
    calls = []

    def float_fn(p):
        calls.append(("float", p))
        return p + 1, {"f": 1}

    def quant_fn(p):
        calls.append(("quant", p))
        return {"d": p * 10}

    def retrain_fn(p, d):
        calls.append(("retrain", p, d["d"]))
        return p + 100, {"r": 2}

    got = qat.three_step_pipeline(0, float_fn, quant_fn, retrain_fn)
    ref_calls = list(calls)
    calls.clear()
    ref = jqat.three_step_pipeline(0, float_fn, quant_fn, retrain_fn)
    assert tuple(got) == tuple(ref) == (1, 101, {"d": 10}, {"f": 1}, {"r": 2})
    assert ref_calls == calls == [("float", 0), ("quant", 1), ("retrain", 1, 10)]
    assert got._fields == ref._fields


# --- training ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_task():
    return (jsyn.digit_task(n_train=1000, n_test=200),
            synthetic.digit_task(n_train=1000, n_test=200))


def test_train_mlp_float_matches_jax(jtree, tree, small_task):
    """2 epochs of 10 SGD steps from the same init: params within rtol
    1e-4 (atol 1e-6), final loss within 1e-5; evaluate gives the same MCR
    on the same params."""
    jt, t = small_task
    kw = dict(epochs=2, batch=100, lr=0.1, momentum=0.9, seed=0)
    jp, jstats = jpipe.train_mlp(jtree, jt, policy=JFLOAT, **kw)
    p, stats = pipeline.train_mlp(tree, t, policy=FLOAT, **kw)
    jp = jax.device_get(jp)
    for path, r in flatten_with_path(jp).items():
        np.testing.assert_allclose(flatten_with_path(p)[path].numpy(), r,
                                   rtol=1e-4, atol=1e-6, err_msg=path)
    assert abs(stats["final_loss"] - jstats["final_loss"]) <= 1e-5
    assert not flatten_with_path(tree)["fc0/w"].requires_grad
    for pol, jpol in ((FLOAT, JFLOAT), (W3A8, JW3A8)):
        assert pipeline.evaluate(bridge.to_torch(jp), t, policy=pol,
                                 batch=100) == \
            jpipe.evaluate(jp, jt, policy=jpol, batch=100)


def test_train_mlp_w3a8_matches_jax(jtree, tree, small_task):
    """1 epoch of STE retraining (delta refit in every step, 8-bit
    signals): params within rtol 1e-3 (atol 1e-5) and at least 99.9% of the
    exported 3/8-bit levels agree. A refit delta differs in its last bits,
    so a weight on a rounding edge may take the neighbouring level."""
    jt, t = small_task
    kw = dict(epochs=1, batch=100, lr=0.1, momentum=0.9, seed=100)
    jp, jstats = jpipe.train_mlp(jtree, jt, policy=JW3A8, **kw)
    p, stats = pipeline.train_mlp(tree, t, policy=W3A8, **kw)
    jp = jax.device_get(jp)
    for path, r in flatten_with_path(jp).items():
        np.testing.assert_allclose(flatten_with_path(p)[path].numpy(), r,
                                   rtol=1e-3, atol=1e-5, err_msg=path)
    assert abs(stats["final_loss"] - jstats["final_loss"]) <= 1e-4
    jq = flatten_with_path(jax.device_get(jqd.export_levels(jp, JW3A8)))
    q = flatten_with_path(quant_dense.export_levels(p, W3A8))
    levels = [p_ for p_ in jq if p_.endswith("/q")]
    agree = sum(int((q[k].numpy() == jq[k]).sum()) for k in levels)
    total = sum(jq[k].size for k in levels)
    assert agree / total >= 0.999
