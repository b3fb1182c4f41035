"""The four kernels' plain PyTorch versions (what the port's ``ops`` wrappers
run on a CPU tensor) against the JAX Pallas kernels in interpret mode and
the JAX ``ref.py`` oracles, in fp32 with atol/rtol 1e-5 (sums are taken in
another order). Cases: K not a multiple of 10, the transposed-W tied
readout, ragged lengths with a 0-length row, int8 KV scales, and lo/hi
windows with empty rows. The CUDA kernels themselves are held against
these plain versions on the card by tests/test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attn_decode import ops as jdec_ops
from repro.kernels.attn_decode.ref import attn_decode_ref as jdec_ref
from repro.kernels.attn_prefill import ops as jpf_ops
from repro.kernels.attn_prefill.ref import attn_prefill_ref as jpf_ref
from repro.kernels.qmatmul import ops as jqmm_ops
from repro.kernels.qmatmul.ref import qmatmul_ref as jqmm_ref
from repro.kernels.qmatvec import ops as jqmv_ops
from repro.kernels.qmatvec.ref import qmatvec_ref as jqmv_ref
from repro.core.packing import pack_matrix as jpack_matrix

from repro_torch.kernels.attn_decode import ops as dec_ops
from repro_torch.kernels.attn_prefill import ops as pf_ops
from repro_torch.kernels.attn_prefill import ref as pf_ref
from repro_torch.kernels.qmatmul import ops as qmm_ops
from repro_torch.kernels.qmatvec import ops as qmv_ops

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, *refs):
    for r in refs:
        np.testing.assert_allclose(got.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("m,k,n", [(3, 23, 16), (8, 40, 24), (1, 7, 5)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_qmatvec_plain_matches_jax(m, k, n, with_bias):
    rng = np.random.default_rng(m * 100 + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    lv = rng.integers(-3, 4, (k, n)).astype(np.int8)
    w = np.asarray(jpack_matrix(jnp.asarray(lv), 3))
    delta = rng.uniform(0.01, 0.1, n).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32) if with_bias else None
    jb = None if bias is None else jnp.asarray(bias)
    ref_k = jqmv_ops.qmatvec(jnp.asarray(x), jnp.asarray(w),
                             jnp.asarray(delta), k=k, bias=jb, interpret=True)
    ref_r = jqmv_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(delta), k,
                     bias=jb)
    got = qmv_ops.qmatvec(_t(x), _t(w), _t(delta), k=k,
                          bias=None if bias is None else _t(bias))
    _close(got, ref_k, ref_r)


def test_qmatvec_leading_dims_and_out_dtype():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 13)).astype(np.float32)
    lv = rng.integers(-3, 4, (13, 6)).astype(np.int8)
    w = np.asarray(jpack_matrix(jnp.asarray(lv), 3))
    ref = jqmv_ops.qmatvec(jnp.asarray(x), jnp.asarray(w), jnp.float32(0.5),
                           k=13, interpret=True, out_dtype=jnp.bfloat16)
    got = qmv_ops.qmatvec(_t(x), _t(w), 0.5, k=13, out_dtype=torch.bfloat16)
    assert got.shape == (2, 3, 6) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref, np.float32))


@pytest.mark.parametrize("m,k,n", [(4, 40, 24), (5, 33, 130)])
def test_qmatmul_plain_matches_jax(m, k, n):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    delta = rng.uniform(0.001, 0.01, n).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(delta), jnp.asarray(bias))
    got = qmm_ops.qmatmul(_t(x), _t(w), _t(delta), bias=_t(bias))
    _close(got, jqmm_ops.qmatmul(*args, interpret=True), jqmm_ref(*args))


def test_qmatmul_transposed_readout_view():
    """The tied readout: W = q.T of a (V, D) table, delta 1 — the port
    passes the strided view, never a copy."""
    rng = np.random.default_rng(11)
    v, d, m = 70, 48, 3
    table = rng.integers(-127, 128, (v, d)).astype(np.int8)
    h = rng.standard_normal((m, d)).astype(np.float32)
    ref_k = jqmm_ops.qmatmul(jnp.asarray(h), jnp.asarray(table).T, 1.0,
                             interpret=True)
    ref_r = jqmm_ref(jnp.asarray(h), jnp.asarray(table).T, 1.0)
    tt = _t(table)
    view = tt.T
    assert view.data_ptr() == tt.data_ptr() and not view.is_contiguous()
    got = qmm_ops.qmatmul(_t(h), view, 1.0)
    assert got.shape == (m, v)
    _close(got, ref_k, ref_r)


def _decode_inputs(quantized, seed=0, b=4, s=24, kv=2, g=3, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, kv * g, d)).astype(np.float32)
    if quantized:
        k = rng.integers(-127, 128, (b, s, kv, d)).astype(np.int8)
        v = rng.integers(-127, 128, (b, s, kv, d)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (b, s)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (b, s)).astype(np.float32)
    else:
        k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
        v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
        ks = vs = None
    lens = np.array([0, 5, s, 13][:b], np.int32)        # ragged, one empty
    return q, k, v, lens, ks, vs


@pytest.mark.parametrize("quantized", [False, True])
def test_attn_decode_plain_matches_jax(quantized):
    q, k, v, lens, ks, vs = _decode_inputs(quantized)
    j = [None if a is None else jnp.asarray(a) for a in (q, k, v, lens, ks, vs)]
    ref_k = jdec_ops.attn_decode(*j, bs=8, interpret=True)
    ref_r = jdec_ref(*j)
    t = [None if a is None else _t(a) for a in (q, k, v, lens, ks, vs)]
    got = dec_ops.attn_decode(*t)
    assert got.shape == q.shape
    _close(got, ref_k, ref_r)
    np.testing.assert_array_equal(got[0].numpy(), 0.0)  # len-0 row: zeros


def _prefill_inputs(quantized, seed=1, b=3, t=16, s=16, kv=2, g=2, d=16):
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
    lo = rng.integers(0, s, (b, t)).astype(np.int32)
    hi = np.minimum(lo + rng.integers(-3, 9, (b, t)), s).astype(np.int32)
    hi[0, :4] = lo[0, :4]                                # empty windows
    return q, k, v, lo, hi, ks, vs


@pytest.mark.parametrize("quantized", [False, True])
def test_attn_prefill_plain_matches_jax(quantized):
    q, k, v, lo, hi, ks, vs = _prefill_inputs(quantized)
    jq, jk, jv, jlo, jhi = (jnp.asarray(a) for a in (q, k, v, lo, hi))
    jks = None if ks is None else jnp.asarray(ks)
    jvs = None if vs is None else jnp.asarray(vs)
    ref_k = jpf_ops.attn_prefill(jq, jk, jv, jhi, lo=jlo, k_scale=jks,
                                 v_scale=jvs, bt=8, bs=8, interpret=True)
    b, t, h, d = q.shape
    qg = (jq * (d ** -0.5)).reshape(b, t, 2, h // 2, d)
    ref_r = jpf_ref(qg, jk, jv, jlo, jhi, jks, jvs).reshape(b, t, h, d)
    got = pf_ops.attn_prefill(_t(q), _t(k), _t(v), _t(hi), lo=_t(lo),
                              k_scale=None if ks is None else _t(ks),
                              v_scale=None if vs is None else _t(vs))
    _close(got, ref_k, ref_r)
    empty = hi <= lo
    assert empty.any()
    np.testing.assert_array_equal(got.numpy()[empty], 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantized", [False, True])
def test_attn_prefill_lse(dtype, quantized):
    """``with_lse``: the output equals the reference's plain version (the
    Pallas kernel in interpret mode too, in fp32) within the file's 1e-5 in
    fp32, and within 1e-2 in bf16 (a few ulp of bf16 at |x| <= 1: the two
    round the probabilities and the output at the same places, their sums
    in another order); the log-sum-exp equals a float64 logsumexp of the
    same pre-scaled scores within 1e-6 x max|lse|, -inf exactly where a
    query sees no key. lo > 0 and empty windows come from the inputs."""
    q, k, v, lo, hi, ks, vs = _prefill_inputs(quantized, seed=5)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    b, t, h, d = q.shape
    kv = k.shape[2]
    tq = _t(q).to(tdt)
    tk, tv = _t(k), _t(v)
    if not quantized:
        tk, tv = tk.to(tdt), tv.to(tdt)
    tks = None if ks is None else _t(ks)
    tvs = None if vs is None else _t(vs)
    got, lse = pf_ops.attn_prefill(tq, tk, tv, _t(hi), lo=_t(lo),
                                   k_scale=tks, v_scale=tvs, with_lse=True)
    assert got.dtype == tdt and lse.dtype == torch.float32
    assert lse.shape == (b, t, h)
    jq = jnp.asarray(q).astype(jdt)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    if not quantized:
        jk, jv = jk.astype(jdt), jv.astype(jdt)
    jks = None if ks is None else jnp.asarray(ks)
    jvs = None if vs is None else jnp.asarray(vs)
    qg = (jq * jnp.asarray(d ** -0.5, jdt)).reshape(b, t, kv, h // kv, d)
    ref = np.asarray(jpf_ref(qg, jk, jv, jnp.asarray(lo), jnp.asarray(hi),
                             jks, jvs).reshape(b, t, h, d).astype(jnp.float32))
    tol = TOL if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)
    if dtype == "float32":
        ref_k = jpf_ops.attn_prefill(jq, jk, jv, jnp.asarray(hi),
                                     lo=jnp.asarray(lo), k_scale=jks,
                                     v_scale=jvs, bt=8, bs=8, interpret=True)
        _close(got, ref_k)
    # float64 logsumexp of the same pre-scaled scores
    qs = np.asarray(qg.astype(jnp.float32), np.float64)
    kf = np.asarray(jk.astype(jnp.float32), np.float64)
    sc = np.einsum("btkgd,bskd->btkgs", qs, kf)
    if ks is not None:
        sc = sc * ks.astype(np.float64)[:, None, None, None, :]
    pos = np.arange(k.shape[1])
    vis = (pos[None, None] >= lo[..., None]) & (pos[None, None] < hi[..., None])
    sc = np.where(vis[:, :, None, None], sc, -np.inf)
    mx = sc.max(-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        want = mx + np.log(np.exp(sc - np.where(np.isfinite(mx), mx, 0)[
            ..., None]).sum(-1))
    want = want.reshape(b, t, h)
    empty = np.broadcast_to((hi <= lo)[..., None], want.shape)
    assert empty.any() and np.isneginf(want[empty]).all()
    got_lse = lse.double().numpy()
    assert np.isneginf(got_lse[empty]).all()
    np.testing.assert_allclose(got_lse[~empty], want[~empty],
                               atol=1e-6 * np.abs(want[~empty]).max())
    np.testing.assert_array_equal(got.float().numpy()[
        np.broadcast_to(empty[..., None], got.shape)], 0.0)
    # with_lse leaves the output as it is without it
    assert torch.equal(got, pf_ops.attn_prefill(tq, tk, tv, _t(hi),
                                                lo=_t(lo), k_scale=tks,
                                                v_scale=tvs))


def test_attn_prefill_bucketed_rule():
    """hi = min(t+1, len) — the admission mask — with a length-1 dummy row."""
    q, k, v, _, _, _, _ = _prefill_inputs(False, seed=4)
    b, t = q.shape[:2]
    lens = np.array([16, 5, 1], np.int32)
    hi = np.minimum(np.arange(t)[None, :] + 1, lens[:, None]).astype(np.int32)
    ref = jpf_ops.attn_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(hi), interpret=True)
    got = pf_ops.attn_prefill(_t(q), _t(k), _t(v), _t(hi))
    _close(got, ref)


def test_plain_versions_count_their_calls():
    q, k, v, lo, hi, _, _ = _prefill_inputs(False)
    before = pf_ref.calls
    pf_ops.attn_prefill(_t(q), _t(k), _t(v), _t(hi), lo=_t(lo))
    assert pf_ref.calls == before + 1
