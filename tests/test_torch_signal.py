"""The paper MLP's activation stage as one op, ``sigmoid_pw_signal``: the PLAN
sigmoid and the per-row unsigned 8-bit signal after it
(``kernels/sigmoid_pw``, the ``signal`` route of ``csrc/sigmoid_pw.cu``),
on the CPU through its plain version.

Tolerances, with their reasons:
- bit-identical: the plain stage against the port's two-call chain
  ``qat.fake_quant_act(sigmoid_pw(x), bits, signed=False)`` and against the
  reference's chain run op by op (the same IEEE operations in the same
  order); NaN where, and only where, the chain has NaN;
- DNN logits within 1e-5 x max|logit| of the reference's jitted forward,
  as ``tests/test_torch_paper.py::test_dnn_forward_matches_jax`` holds them
  (matmul summation order; under ``jax.jit`` XLA rewrites the divisions);
- the gradient of the chain, kept where a gradient is recorded, within
  1e-6 x max|grad| of the reference's op-by-op gradient (the matmuls sum
  in another order; the chain's own gradients are held bit for bit by
  ``tests/test_torch_paper.py``).

The CUDA kernel itself runs only on a card (``tests/test_torch_gpu.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import qat as jqat
from repro.core import quant_dense as jqd
from repro.core.precision import W3A8 as JW3A8
from repro.kernels.sigmoid_pw import ref as jsig
from repro.models import dnn as jdnn

from repro_torch import bridge
from repro_torch.analysis import smem
from repro_torch.analysis.contracts import kernel_op_counts
from repro_torch.analysis.trace import fake_mode, fake_tree, find_kernel_ops, trace
from repro_torch.core import qat, quant_dense
from repro_torch.core.precision import W3A8
from repro_torch.kernels.sigmoid_pw import kernel as sig_k
from repro_torch.kernels.sigmoid_pw import ops as sig_ops
from repro_torch.kernels.sigmoid_pw import ref as sig_ref
from repro_torch.models import dnn

CUDA = torch.device("cuda", 0)
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}
SHAPES = [(100, 1022), (128, 61), (3, 7)]
HIDDEN = (64, 64, 64)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _input(shape, dtype, seed=0):
    """x * 4 from a numpy seed, with row 0 all <= -5 (scale 1e-12, all
    zeros), a NaN in row 1 and +-inf in row 2."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 4).astype(np.float32)
    x[0] = -5.0 - np.abs(x[0])
    x[1, shape[1] // 2] = np.nan
    x[2, 0], x[2, -1] = np.inf, -np.inf
    return x.astype(DTYPES[dtype][0])


def _t(a):
    return bridge.to_torch(np.asarray(a))


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _assert_same_bits(got, ref):
    """Identical bit patterns where the reference is a number, NaN exactly
    where it is NaN."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    nan = np.isnan(ref.astype(np.float32))
    np.testing.assert_array_equal(np.isnan(got.astype(np.float32)), nan)
    ui = np.uint32 if got.dtype == np.float32 else np.uint16
    np.testing.assert_array_equal(got.view(ui)[~nan], ref.view(ui)[~nan])


# --- the plain stage against the chains -------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_signal_is_fake_quant_act_of_sigmoid_pw(dtype, bits, shape):
    x = _t(_input(shape, dtype))
    got = sig_ref.sigmoid_pw_signal(x, bits)
    want = qat.fake_quant_act(sig_ref.sigmoid_pw(x), bits, signed=False)
    _assert_same_bits(_np(got), _np(want))
    # the row of x <= -5 is all zeros, the NaN row all NaN, +-inf finite
    assert not got[0].any() and torch.isnan(got[1]).all()
    assert torch.isfinite(got[2]).all()
    # the public op takes the plain version for a CPU tensor
    _assert_same_bits(_np(sig_ops.sigmoid_pw_signal(x, bits)), _np(got))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_signal_is_the_references_chain(dtype, shape):
    """The same numpy inputs through the reference's chain, op by op:
    the same bits."""
    x = _input(shape, dtype, seed=1)
    want = np.asarray(jqat.fake_quant_act(jsig.sigmoid_pw(jnp.asarray(x)), 8,
                                          signed=False))
    _assert_same_bits(_np(sig_ops.sigmoid_pw_signal(_t(x), 8)), want)


def test_signal_keeps_the_shape_of_x_and_one_scale_a_leading_row():
    """ndim > 2: a scale per leading row over every other axis; 1-D: one
    scale, as ``fake_quant_act`` takes them."""
    for shape in ((4, 3, 5), (11,)):
        x = _t(_input((4, 15), "float32", seed=2).reshape(-1)[:np.prod(
            shape)].reshape(shape))
        x = torch.where(torch.isfinite(x), x, torch.zeros(()))
        got = sig_ops.sigmoid_pw_signal(x, 8)
        assert got.shape == x.shape
        want = qat.fake_quant_act(sig_ref.sigmoid_pw(x), 8, signed=False)
        _assert_same_bits(_np(got), _np(want))
    assert sig_ops.sigmoid_pw_signal(torch.zeros((0, 5)), 8).shape == (0, 5)


def test_signal_refuses_a_gradient_and_an_unknown_device():
    x = torch.zeros((2, 3), requires_grad=True)
    with pytest.raises(ValueError, match="no gradient"):
        sig_ops.sigmoid_pw_signal(x, 8)
    with torch.no_grad():
        sig_ops.sigmoid_pw_signal(x, 8)
    with pytest.raises(ValueError, match="no path"):
        sig_ops.sigmoid_pw_signal(torch.empty((2, 3), device="meta"), 8)


# --- the launch plan ---------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 61, 64, 1022, 1024, 4096, 8191, 40000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
def test_signal_plan_covers_each_row_once(n, dtype, aligned):
    """A CPU emulation of the kernel's indexing (csrc/sigmoid_pw.cu,
    sigmoid_pw_kernel_signal) for the plan ``signal_plan`` gives: every
    element of every row is read by its row's group exactly once and stored
    exactly once, 16-byte stores only of vectors inside the row; the held
    vectors cover the row's window (the streamed kernel loops)."""
    m = 5
    p = sig_k.signal_plan(m, n, dtype, aligned)
    assert p.group % 32 == 0 and 256 % p.group == 0
    assert p.rows == 256 // p.group and p.grid == -(-m // p.rows)
    total, v = m * n, p.vec
    written = np.zeros(total, np.int64)
    for row in range(m):
        rs, re = row * n, row * n + n
        vs, ve = rs // v, (re + v - 1) // v
        seen = np.zeros(total, np.int64)
        for t in range(p.group):
            js = (range(vs + t, ve, p.group) if p.held == 0 else
                  [j for j in (vs + t + i * p.group for i in range(p.held))
                   if j < ve])
            for j in js:
                lanes = np.arange(j * v, (j + 1) * v)
                lanes = lanes[(lanes >= rs) & (lanes < re)]
                seen[lanes] += 1
                if v > 1 and j * v >= rs and (j + 1) * v <= re:
                    assert (j + 1) * v <= total      # a whole vector store
                written[lanes] += 1
        assert (seen[rs:re] == 1).all() and seen.sum() == n
        if p.held:
            assert ve - vs <= p.group * p.held
    assert (written == 1).all()


# --- dnn.forward ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def jtree():
    return jax.device_get(jax.jit(lambda k: jdnn.init(k, 784, HIDDEN, 10))(
        jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def xs():
    return np.random.default_rng(3).random((32, 784)).astype(np.float32)


def _counting(monkeypatch):
    """Count the calls dnn.forward makes of each activation path."""
    calls = {"signal": 0, "sigmoid_pw": 0, "fake_quant_act": 0}

    def wrap(mod, name, key):
        fn = getattr(mod, name)

        def counted(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    wrap(dnn.sig_ops, "sigmoid_pw_signal", "signal")
    wrap(dnn.sig_ops, "sigmoid_pw", "sigmoid_pw")
    wrap(dnn.qat, "fake_quant_act", "fake_quant_act")
    return calls


def test_deployed_forward_takes_the_fused_stage(jtree, xs, monkeypatch):
    """The W3A8 container forward with 8-bit signals and grad off: one
    ``sigmoid_pw_signal`` a hidden layer and no two-call chain; the logits
    equal the port's chain bit for bit and the reference's within 1e-5 x
    max|logit|."""
    served = quant_dense.export_container(bridge.to_torch(jtree), W3A8)
    x = torch.from_numpy(xs)
    calls = _counting(monkeypatch)
    with torch.no_grad():
        got = dnn.forward(served, x, policy=W3A8, sigmoid_mode="pw")
    assert calls == {"signal": 3, "sigmoid_pw": 0, "fake_quant_act": 0}
    h = x
    for name in ("fc0", "fc1", "fc2", "head"):
        role = "output" if name == "head" else "hidden"
        h = quant_dense.apply(served[name], h, policy=W3A8, role=role)
        if name != "head":
            h = qat.fake_quant_act(sig_ref.sigmoid_pw(h), 8, signed=False)
    assert torch.equal(got, h)
    jp = jax.device_get(jqd.export_container(jtree, JW3A8))
    ref = np.asarray(jax.jit(lambda p_, x_: jdnn.forward(
        p_, x_, policy=JW3A8, sigmoid_mode="pw"))(jp, jnp.asarray(xs)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_forward_that_records_a_gradient_keeps_the_chain(jtree, xs,
                                                          monkeypatch):
    """Grad on: the two calls and their gradient, the reference's gradient
    of the same forward run op by op; grad off on the same master: the
    fused stage and the same logits bit for bit."""
    tree = bridge.to_torch(jtree)
    deltas = bridge.to_torch(jax.device_get(jqd.fit_deltas(jtree, JW3A8)))
    x = torch.from_numpy(xs).requires_grad_(True)
    calls = _counting(monkeypatch)
    out = dnn.forward(tree, x, policy=W3A8, deltas=deltas, sigmoid_mode="pw")
    assert calls == {"signal": 0, "sigmoid_pw": 3, "fake_quant_act": 3}
    r = np.random.default_rng(4).standard_normal(out.shape).astype(np.float32)
    (out * torch.from_numpy(r)).sum().backward()
    jd = jqd.fit_deltas(jtree, JW3A8)
    with jax.disable_jit():
        jg = np.asarray(jax.grad(lambda v: jnp.sum(jdnn.forward(
            jtree, v, policy=JW3A8, deltas=jd, sigmoid_mode="pw")
            * jnp.asarray(r)))(jnp.asarray(xs)))
    # measured 2.9e-7 x max|grad|: the matmuls sum in another order
    np.testing.assert_allclose(x.grad.numpy(), jg, rtol=0,
                               atol=1e-6 * np.abs(jg).max())
    with torch.no_grad():
        fused = dnn.forward(tree, x, policy=W3A8, deltas=deltas,
                            sigmoid_mode="pw")
    assert calls["signal"] == 3
    assert torch.equal(fused, out.detach())


def test_float_and_exact_forwards_keep_their_paths(jtree, xs, monkeypatch):
    """No 8-bit signal, or the exact sigmoid: nothing fused."""
    tree = bridge.to_torch(jtree)
    x = torch.from_numpy(xs)
    calls = _counting(monkeypatch)
    with torch.no_grad():
        dnn.forward(tree, x, policy=dataclasses.replace(W3A8, act_bits=None),
                    sigmoid_mode="pw")
        dnn.forward(tree, x, policy=W3A8, sigmoid_mode="exact")
    assert calls == {"signal": 0, "sigmoid_pw": 3, "fake_quant_act": 3}


# --- the op under fake tensors ----------------------------------------------------------

def test_signal_op_traces_under_fake_tensors():
    """On fake "cuda" tensors the op returns the launch's output, notes the
    plan the launch uses and launches nothing; analysis.smem names its CUDA
    function and static shared bytes; the deployed forward traces as
    qmatvec, the signal route and qmatmul per layer."""
    fm = fake_mode()
    with fm:
        x = torch.empty((100, 1022), device=CUDA)
    before = (sig_k.launches, dict(sig_k.launches_by_variant))
    tr = trace(lambda: sig_ops.sigmoid_pw_signal(x, 8), mode=fm)
    assert (sig_k.launches, sig_k.launches_by_variant) == before
    assert kernel_op_counts(tr, by_variant=True) == {"sigmoid_pw/signal": 1}
    (rec,) = find_kernel_ops(tr)
    assert rec.name == "repro_torch.sigmoid_pw_signal.default"
    y = tr.result
    assert (tuple(y.shape), y.dtype, y.device) == ((100, 1022),
                                                  torch.float32, CUDA)
    plan = sig_k.signal_plan(100, 1022, torch.float32)
    assert rec.kernel["plan"] == plan and rec.kernel["grid"] == (plan.grid,)
    assert plan == sig_k.SignalPlan(vec=4, group=256, held=1, rows=1,
                                    grid=100)
    assert smem.launch_functions(rec.kernel) == [
        ("sigmoid_pw_kernel_signal", 0)]
    est = smem.kernel_smem_estimate(rec)
    assert est["static_bytes"] == smem.STATIC_SMEM[
        "sigmoid_pw_kernel_signal"] == 32

    master = dnn.init(torch.Generator().manual_seed(0), 784, (1022,) * 3, 10)
    fm = fake_mode()
    served = fake_tree(quant_dense.export_container(master, W3A8), fm, CUDA)
    with fm:
        xb = torch.empty((100, 784), device=CUDA)
    tr = trace(lambda: dnn.forward(served, xb, policy=W3A8,
                                   sigmoid_mode="pw"), mode=fm)
    assert kernel_op_counts(tr, by_variant=True) == {
        "qmatvec/prefill": 3, "sigmoid_pw/signal": 3,
        "qmatmul/k_lanes/k_major": 1}
