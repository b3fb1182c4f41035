"""The port's core numerics against the JAX package on the CPU: packing
(bit-identical words), the quantizer, activation fake-quant, the W3A8
serve-form export of a bridged reduced qwen2-1.5b tree, and the bridge.

Tolerances: words and levels must be identical; fp32 deltas agree within
rtol 1e-6 (the two frameworks sum the 1-D least-squares terms in another
order); fake_quant_act within 1 ulp."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import packing as jpacking
from repro.core import qat as jqat
from repro.core import quant_dense as jqd
from repro.core import quantizer as jqz
from repro.core.precision import W3A8 as JW3A8
from repro.models import get_model as jget_model

from repro_torch import bridge
from repro_torch.core import packing, qat, quant_dense, quantizer as qz
from repro_torch.core.precision import FLOAT, W3A8
from repro_torch.core.treeutil import flatten_with_path, role_of


def _levels(rng, shape, bits):
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return rng.integers(lo, hi + 1, size=shape).astype(np.int8)


@pytest.mark.parametrize("k", [10, 23, 40, 1])
def test_pack_matrix_bit_identical_and_roundtrip(k):
    rng = np.random.default_rng(k)
    q = _levels(rng, (k, 7), 3)
    ref = np.asarray(jpacking.pack_matrix(jnp.asarray(q), 3))
    got = packing.pack_matrix(torch.from_numpy(q), 3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(packing.unpack_matrix(got, k, 3).numpy(), q)


def test_pack_matrix_stacked_layers():
    rng = np.random.default_rng(1)
    q = _levels(rng, (3, 17, 5), 3)
    got = packing.pack_matrix(torch.from_numpy(q), 3).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], np.asarray(jpacking.pack_matrix(jnp.asarray(q[i]), 3)))


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_pack_int32_bit_identical(bits):
    rng = np.random.default_rng(bits)
    q = _levels(rng, (53,), bits)
    ref = np.asarray(jpacking.pack_int32(jnp.asarray(q), bits))
    got = packing.pack_int32(torch.from_numpy(q), bits)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        packing.unpack_int32(got, 53, bits).numpy(), q)


@pytest.mark.parametrize("bad", [4, -5])
def test_check_levels_raises(bad):
    q = np.zeros((12, 3), np.int8)
    q[5, 1] = bad
    with pytest.raises(ValueError, match="out of range for 3-bit"):
        packing.pack_matrix(torch.from_numpy(q), 3)
    with pytest.raises(ValueError, match="out of range for 3-bit"):
        jpacking.pack_matrix(jnp.asarray(q), 3)


@pytest.mark.parametrize("per_channel", [None, -1, 0])
@pytest.mark.parametrize("bits", [3, 8])
def test_optimal_uniform_delta_and_levels_match(per_channel, bits):
    rng = np.random.default_rng(7)
    w = rng.standard_normal((48, 24)).astype(np.float32)
    w[:, 3] = 0.0                                   # an all-zero channel
    jspec = jqz.QuantSpec(bits=bits, per_channel=per_channel)
    spec = qz.QuantSpec(bits=bits, per_channel=per_channel)
    jd = np.asarray(jqz.optimal_uniform_delta(jnp.asarray(w), jspec))
    d = qz.optimal_uniform_delta(torch.from_numpy(w), spec)
    assert tuple(d.shape) == jd.shape
    np.testing.assert_allclose(d.numpy(), jd, rtol=1e-6)
    # levels from the SAME delta are identical (round half to even)
    jq = np.asarray(jqz.quantize_levels(jnp.asarray(w), jnp.asarray(jd), jspec))
    q = qz.quantize_levels(torch.from_numpy(w), torch.tensor(jd), spec)
    np.testing.assert_array_equal(q.numpy(), jq)


def test_quantize_levels_half_to_even():
    w = np.array([0.5, 1.5, 2.5, -0.5, -1.5], np.float32)
    spec = qz.QuantSpec(bits=3)
    got = qz.quantize_levels(torch.from_numpy(w), torch.tensor(1.0), spec)
    np.testing.assert_array_equal(got.numpy(), [0, 2, 2, 0, -2])


@pytest.mark.parametrize("shape", [(5, 33), (3, 4, 16), (40,)])
@pytest.mark.parametrize("signed", [True, False])
def test_fake_quant_act_within_one_ulp(shape, signed):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    if not signed:
        x = np.abs(x)
    ref = np.asarray(jqat.fake_quant_act(jnp.asarray(x), 8, signed))
    got = qat.fake_quant_act(torch.from_numpy(x), 8, signed).numpy()
    np.testing.assert_array_max_ulp(got, ref, maxulp=1)


@pytest.mark.parametrize("fixed", [False, True])
def test_effective_weight_and_apply_take_delta(fixed):
    """The reference's signatures: ``effective_weight(params, policy, role,
    delta, k)`` and ``apply(..., delta=)``; a float master under a
    quantizing policy is the STE fake-quant view. A fixed delta gives the
    reference's weight bit for bit; a refit one within rtol 1e-6."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal((40, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    x = rng.standard_normal((5, 40)).astype(np.float32)
    jd = (jqz.optimal_uniform_delta(jnp.asarray(w), jqz.QuantSpec(bits=3))
          * 1.1 if fixed else None)
    jleaf = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    leaf = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    d = None if jd is None else torch.from_numpy(np.array(jd))
    ref_w = np.asarray(jqd.effective_weight(jleaf, JW3A8, "hidden", jd))
    got_w = quant_dense.effective_weight(leaf, W3A8, "hidden", d).numpy()
    if fixed:
        np.testing.assert_array_equal(got_w, ref_w)
    else:
        np.testing.assert_allclose(got_w, ref_w, rtol=1e-6)
    ref_y = np.asarray(jqd.apply(jleaf, jnp.asarray(x), policy=JW3A8,
                                 role="hidden", delta=jd))
    got_y = quant_dense.apply(leaf, torch.from_numpy(x), policy=W3A8,
                              role="hidden", delta=d).numpy()
    np.testing.assert_allclose(got_y, ref_y, rtol=1e-5, atol=1e-5)
    assert quant_dense.effective_weight(leaf, FLOAT, "hidden", d) is leaf["w"]


def test_role_of_matches():
    from repro.core.treeutil import role_of as jrole_of
    for p in ("layers/attn/wq/w", "layers/attn/wq/b", "embed/w", "head/w",
              "layers/ln1/scale", "final_norm/scale", "moe/router/w"):
        assert role_of(p) == jrole_of(p)


@pytest.fixture(scope="module")
def jax_tree():
    cfg = jreduced(jget_config("qwen2-1.5b"))
    params = jget_model(cfg).init(jax.random.PRNGKey(0), cfg)
    return params


@pytest.mark.parametrize("form", ["q", "qp"])
def test_export_matches_jax(jax_tree, form):
    jexport = {"q": jqd.export_levels, "qp": jqd.export_container}[form]
    export = {"q": quant_dense.export_levels,
              "qp": quant_dense.export_container}[form]
    ref = flatten_with_path(jax.device_get(jexport(jax_tree, JW3A8)))
    got = flatten_with_path(export(bridge.to_torch(
        jax.device_get(jax_tree)), W3A8))
    assert sorted(ref) == sorted(got)
    for path, r in ref.items():
        g = got[path].numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, path
        if path.endswith("delta"):
            np.testing.assert_allclose(g, r, rtol=1e-6, err_msg=path)
        else:
            np.testing.assert_array_equal(g, r, err_msg=path)
    assert any(p.endswith("/qp") for p in got) == (form == "qp")


@pytest.mark.parametrize("form", ["q", "qp"])
@pytest.mark.parametrize("mode", ["dequant", "kernel"])
def test_serve_apply_against_effective_weight(jax_tree, form, mode):
    """serve_apply never builds the dequantized weight, but must equal the
    product with it; effective_weight itself matches the reference's."""
    jexport = {"q": jqd.export_levels, "qp": jqd.export_container}[form]
    jleaf = jax.tree_util.tree_map(
        lambda a: a[0], jexport(jax_tree, JW3A8)["layers"]["attn"]["wq"])
    leaf = bridge.to_torch(jax.device_get(jleaf))
    x = np.random.default_rng(5).standard_normal((6, 64)).astype(np.float32)
    w = quant_dense.effective_weight(leaf, W3A8, "hidden", k=64)
    np.testing.assert_allclose(
        w.numpy(), np.asarray(jqd.effective_weight(jleaf, JW3A8, "hidden",
                                                   k=64)), rtol=1e-6)
    got = quant_dense.serve_apply(leaf, torch.tensor(x), mode=mode)
    ref = torch.tensor(x) @ w + leaf["b"]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)


def test_bridge_bit_exact_roundtrip():
    rng = np.random.default_rng(0)
    tree = {"a": {"w": rng.standard_normal((3, 4)).astype(ml_dtypes.bfloat16)},
            "qp": rng.integers(-2**31, 2**31 - 1, (5, 2)).astype(np.int32),
            "q": _levels(rng, (4, 4), 8),
            "len": np.int32(7)}
    t = bridge.to_torch(tree)
    assert t["a"]["w"].dtype == torch.bfloat16
    assert t["qp"].dtype == torch.int32 and t["q"].dtype == torch.int8
    np.testing.assert_array_equal(
        t["a"]["w"].view(torch.int16).numpy().view(np.uint16),
        tree["a"]["w"].view(np.uint16))
    np.testing.assert_array_equal(t["qp"].numpy(), tree["qp"])
    np.testing.assert_array_equal(t["q"].numpy(), tree["q"])
    assert int(t["len"]) == 7


@pytest.mark.parametrize("bits,per_channel", [(3, None), (3, -1), (8, None),
                                              (2, None)])
def test_quantization_mse_matches(bits, per_channel):
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((33, 17)).astype(np.float32)
    ref = float(jqz.quantization_mse(jnp.asarray(w),
                                     jqz.QuantSpec(bits, per_channel)))
    got = float(qz.quantization_mse(torch.from_numpy(w),
                                    qz.QuantSpec(bits, per_channel)))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("shape,bits", [((10, 7), 3), ((1022, 61), 3),
                                        ((5,), 8), ((3, 4, 5), 2),
                                        ((9, 9), 4)])
def test_packed_nbytes_matches(shape, bits):
    assert packing.packed_nbytes(shape, bits) == \
        jpacking.packed_nbytes(shape, bits)


def test_tree_sizes_and_any_nan_match():
    from repro.core import treeutil as jtu
    from repro_torch.core import treeutil as tu
    rng = np.random.default_rng(3)
    tree = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                  "q": rng.integers(-4, 4, (5, 2)).astype(np.int8)},
            "b": np.arange(6, dtype=np.int32), "n": None}
    jtree = {"a": {k: jnp.asarray(v) for k, v in tree["a"].items()},
             "b": jnp.asarray(tree["b"])}
    ttree = bridge.to_torch(tree)
    assert tu.tree_size(ttree) == jtu.tree_size(jtree) == 12 + 10 + 6
    assert tu.tree_nbytes(ttree) == jtu.tree_nbytes(jtree) == 48 + 10 + 24
    assert tu.any_nan(ttree) is jtu.any_nan(jtree) is False
    tree["a"]["w"][1, 2] = np.nan
    assert tu.any_nan(bridge.to_torch(tree)) is True
    assert jtu.any_nan({"w": jnp.asarray(tree["a"]["w"])}) is True
    assert tu.any_nan({"q": torch.zeros(3, dtype=torch.int8)}) is False


def test_core_reexports_match():
    """The port's ``repro_torch.core`` re-exports the names of the
    reference's ``repro.core``, and its policies equal the reference's."""
    import repro.core as jcore
    import repro_torch.core as core
    assert core.__all__ == jcore.__all__
    for name in core.__all__:
        assert getattr(core, name) is not None, name
    for name in ("FLOAT", "W3A8", "W4A8", "W8", "TERNARY"):
        a, b = getattr(core, name), getattr(jcore, name)
        assert (a.mode, a.bits, a.act_bits, a.per_channel) == \
            (b.mode, b.bits, b.act_bits, b.per_channel), name
    assert core.max_level(3) == jcore.max_level(3)
    assert core.fields_per_word(3) == jcore.fields_per_word(3)
