"""The port's weight-store integrity against the reference on the CPU, at
``reduced(qwen2-1.5b)`` (2 layers, d_model 64, vocab 128), from
JAX-initialised weights bridged as numpy.

Mirrors ``tests/test_integrity.py`` with the reference as the oracle: the
probe's fingerprints and the CRC manifest equal
``repro.checkpoint.integrity.fingerprints`` / ``build_manifest`` for the
float master (fp32 and bf16), the ``q`` and ``qp`` exports and an untied
head stored K-major (its bits counted in the logical (K, N) order); every
single-bit flip of a small leaf is detected and localized by both the
probe and the manifest; a flip lands on the reference's bit; the golden
store is read across packages; and the engine's probe detects a flip
injected by a ``FaultPlan``, heals it from the golden copy and rewinds
the requests at risk, as the JAX engine does (fp32, T = 0, slots 2).
Tolerance: none."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import integrity as jintegrity
from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import quant_dense as jquant_dense
from repro.core.precision import W3A8 as JW3A8
from repro.core.treeutil import tree_get as jtree_get, tree_set as jtree_set
from repro.models import get_model as jget_model
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.resilience import FaultPlan as JFaultPlan

from repro_torch import bridge
from repro_torch.checkpoint import integrity
from repro_torch.configs import get_config, reduced
from repro_torch.core.precision import W3A8
from repro_torch.core.treeutil import flatten_with_path, tree_get, unflatten
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.resilience import FaultPlan

JW3 = dataclasses.replace(JW3A8, act_bits=None)
W3 = dataclasses.replace(W3A8, act_bits=None)
FORMS = ["w", "bf16", "q", "qp", "qp-untied"]


def _jax_tree(form):
    """The reference's tree of ``form`` and its config."""
    jcfg = jreduced(jget_config("qwen2-1.5b"))
    if form == "qp-untied":
        jcfg = dataclasses.replace(jcfg, tie_embeddings=False)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    if form == "bf16":
        jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
    elif form == "q":
        jp = jquant_dense.export_levels(jp, JW3)
    elif form.startswith("qp"):
        jp = jquant_dense.export_container(jp, JW3)
    return jcfg, jp


@pytest.fixture(scope="module")
def trees():
    out = {}
    for form in FORMS:
        jcfg, jp = _jax_tree(form)
        out[form] = (jcfg, jp, bridge.to_torch(jax.device_get(jp)))
    return out


def _jflip(tree, path, bit):
    """The reference's host bit flip (``tests/test_integrity.py``)."""
    a = np.array(np.asarray(jtree_get(tree, path)))
    raw = a.view(np.uint8).reshape(-1)
    b = bit % (raw.size * 8)
    raw[b // 8] ^= np.uint8(1 << (b % 8))
    return jtree_set(tree, path, jnp.asarray(a))


@pytest.mark.parametrize("form", FORMS)
def test_fingerprints_and_manifest_equal_reference(trees, form):
    """Protected paths, fingerprints and the CRC manifest of the bridged
    tree equal the reference's; for the untied qp head the port's leaf is
    the K-major view and is read in its logical order."""
    _, jp, tp = trees[form]
    paths = integrity.protected_paths(tp)
    assert paths == jintegrity.protected_paths(jp)
    np.testing.assert_array_equal(integrity.fingerprints(tp, paths),
                                  jintegrity.fingerprints(jp, paths))
    assert integrity.build_manifest(tp, paths) == \
        jintegrity.build_manifest(jp, paths)
    if form == "qp-untied":
        assert "head/q" in paths
        assert not tree_get(tp, "head/q").is_contiguous()


@pytest.mark.parametrize("form", ["qp-untied", "bf16"])
def test_flip_lands_on_the_reference_bit(trees, form):
    """``flip_bit_`` changes the bit the reference's byte-view flip
    changes (leaf C order, little-endian, wrapping), in place, and the
    fingerprints and manifest verdicts then equal the reference's."""
    _, jp, tp = trees[form]
    paths = integrity.protected_paths(tp)
    manifest = integrity.build_manifest(tp, paths)
    rng = np.random.default_rng(1)
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    for path in (paths[0], paths[-1], "head/q" if form == "qp-untied"
                 else paths[len(paths) // 2]):
        bit = int(rng.integers(1 << 30))
        t = bridge.to_torch(jax.device_get(jp))          # a fresh copy
        leaf = tree_get(t, path)
        integrity.flip_bit_(t, path, bit)
        assert tree_get(t, path) is leaf
        bad = _jflip(jp, path, bit)
        want = bridge.to_torch({"x": np.asarray(jtree_get(bad, path))})["x"]
        view = ints[leaf.element_size()]
        assert torch.equal(leaf.view(view), want.view(view)), path
        np.testing.assert_array_equal(integrity.fingerprints(t, paths),
                                      jintegrity.fingerprints(bad, paths))
        assert integrity.verify_manifest(t, manifest) == [path]


def test_every_single_bit_flip_is_detected_and_localized(trees):
    """Every bit of a small protected leaf (an fp32 ``delta``), flipped in
    turn: the probe's fingerprint of that leaf and only that leaf moves,
    the manifest names it, and flipping the bit back restores the golden
    fingerprints — including the sign and high exponent bits, which a
    float checksum would round away."""
    _, _, tp = trees["qp"]
    paths, probe = integrity.make_probe(tp)
    sizes = {p: tree_get(tp, p).numel() for p in paths}
    victim = min((p for p in paths if p.endswith("delta")), key=sizes.get)
    i = paths.index(victim)
    manifest = integrity.build_manifest(tp, paths)
    golden = probe(tp)
    nbits = sizes[victim] * 32
    assert nbits >= 512
    for bit in range(nbits):
        integrity.flip_bit_(tp, victim, bit)
        moved = torch.nonzero(probe(tp) != golden).flatten().tolist()
        assert moved == [i], (bit, moved)
        if bit % 61 == 0:
            assert integrity.verify_manifest(tp, manifest) == [victim]
        integrity.flip_bit_(tp, victim, bit)
        assert torch.equal(probe(tp), golden)
    assert integrity.verify_manifest(tp, manifest) == []


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_golden_store_read_across_packages(trees, tmp_path, writer):
    """save_golden by one package, load_golden by the other: the same
    leaves, bit for bit, and the same manifest."""
    _, jp, tp = trees["qp-untied"]
    gdir = str(tmp_path / "g")
    if writer == "jax":
        manifest = jintegrity.save_golden(gdir, jp)
        flat, manifest2 = integrity.load_golden(gdir)
    else:
        manifest = integrity.save_golden(gdir, tp)
        flat, manifest2 = jintegrity.load_golden(gdir)
        flat = bridge.to_torch({k: np.asarray(v) for k, v in flat.items()})
    assert manifest2 == manifest == jintegrity.build_manifest(jp)
    for p in integrity.protected_paths(tp):
        assert torch.equal(flat[p].contiguous(),
                           tree_get(tp, p).contiguous()), p
    assert integrity.verify_manifest(unflatten(flat), manifest) == []


PROMPTS = [[1, 2, 3], [7, 8, 9, 10], [20, 21], [30, 31, 32, 33, 34]]


@pytest.mark.parametrize("case", ["heal_at_5", "rewind_at_3"])
def test_engine_detects_and_heals_like_jax(trees, tmp_path, case):
    """A FaultPlan bit flip in a ``qp`` container mid-run: the probe
    (``integrity_every``) detects it, the leaf is healed from the golden
    copy in place, the requests at risk are rewound and requeued; heal and
    probe counts, ``fallback_events``, statuses and tokens equal the JAX
    engine's, and the tokens equal a clean run's. The store then matches
    its manifest, and the golden store was written."""
    jcfg, jp, tp = trees["qp"]
    cfg = reduced(get_config("qwen2-1.5b"))
    victim = [p for p in integrity.protected_paths(tp)
              if p.endswith("/qp")][0]
    tick, bit, every, maxnew = {"heal_at_5": (5, 31337, 1, [7, 5, 8, 6]),
                                "rewind_at_3": (3, 9, 1, [6] * 4)}[case]
    runs = []
    for which in ("jax", "torch", "clean"):
        kw = dict(slots=2, max_len=64)
        if which != "clean":
            kw.update(integrity_every=every,
                      golden_dir=str(tmp_path / which))
        if which == "jax":
            eng = JServingEngine(jp, jcfg, policy=JW3, dtype=jnp.float32,
                                 fault_plan=JFaultPlan(
                                     flip_bits=[(tick, victim, bit)]), **kw)
        else:
            plan = FaultPlan(flip_bits=[(tick, victim, bit)]) \
                if which == "torch" else None
            eng = ServingEngine(bridge.to_torch(jax.device_get(jp)), cfg,
                                policy=W3, dtype=torch.float32,
                                fault_plan=plan, device="cpu", **kw)
        for p, m in zip(PROMPTS, maxnew):
            eng.submit(list(p), max_new=m)
        done = eng.run_all(max_ticks=600)
        runs.append((eng, sorted((r.uid, r.status, list(r.out))
                                 for r in done)))
    (jeng, ref), (eng, got), (_, clean) = runs
    assert got == ref == clean
    assert all(s == "ok" for _, s, _ in got)
    for k in ("heal_count", "integrity_probes", "fallback_events",
              "decode_calls", "prefill_calls"):
        assert getattr(eng, k) == getattr(jeng, k), k
    assert eng.heal_count == 1
    assert eng.fallback_events[-1] == (tick, f"heal:{victim}")
    assert integrity.verify_manifest(eng.params, eng._manifest) == []
    flat, _ = integrity.load_golden(str(tmp_path / "torch"))
    assert victim in flat
    assert eng.captures == {"tick": 0, "admit": {}, "probe": 0}


def test_flip_stays_in_the_engines_own_copy(trees):
    """A FaultPlan flip writes in place into the engine's own copy of the
    leaf it names: the engine serves the flipped bit, and the caller's
    tree, which the engine was built from on the same device, stays clean
    (the reference rebinds the leaf, which leaves its caller's tree clean
    too)."""
    _, _, tp = trees["qp"]
    victim = [p for p in integrity.protected_paths(tp)
              if p.endswith("/qp")][0]
    before = {p: v.clone() for p, v in flatten_with_path(tp).items()}
    eng = ServingEngine(tp, reduced(get_config("qwen2-1.5b")), policy=W3,
                        slots=2, max_len=32, dtype=torch.float32,
                        fault_plan=FaultPlan(flip_bits=[(1, victim, 9)]),
                        device="cpu")
    eng.submit([1, 2, 3], max_new=4)
    eng.run_all(max_ticks=100)
    for p, v in flatten_with_path(tp).items():
        assert torch.equal(v, before[p]), p
    served = tree_get(eng.params, victim)
    assert not torch.equal(served, before[victim])
    integrity.flip_bit_(eng.params, victim, 9)
    assert torch.equal(served, before[victim])


def test_integrity_probe_off_by_default(trees):
    _, _, tp = trees["qp"]
    eng = ServingEngine(tp, reduced(get_config("qwen2-1.5b")), policy=W3,
                        slots=2, max_len=32, dtype=torch.float32,
                        device="cpu")
    eng.submit([1, 2, 3], max_new=3)
    eng.run_all(max_ticks=100)
    assert eng.integrity_probes == 0 and eng._probe_paths is None
    assert "probe" not in eng.captures


def test_tree_get_set_and_in_place_write_match_reference():
    """``tree_get`` / ``tree_set`` as the reference's (KeyError naming the
    missing segment; a functional update that copies only the dicts on
    the path), and ``tree_write_``, the in-place writer the engine's heal
    and restore use: same storage, logical order through a transposed
    view, shape checked."""
    from repro.core.treeutil import tree_get as jget, tree_set as jset
    from repro_torch.core.treeutil import tree_set, tree_write_
    tree = {"a": {"b": torch.arange(6).reshape(2, 3), "c": torch.ones(2)},
            "d": torch.zeros(3, 2).T}
    for path in ("a/x", "a/b/c", "q"):
        with pytest.raises(KeyError) as ref:
            jget(tree, path)
        with pytest.raises(KeyError) as got:
            tree_get(tree, path)
        assert str(got.value) == str(ref.value)
    new = tree_set(tree, "a/b", torch.zeros(2, 3))
    ref = jset(tree, "a/b", torch.zeros(2, 3))
    assert new["a"]["c"] is tree["a"]["c"] is ref["a"]["c"]
    assert new["a"] is not tree["a"] and torch.equal(tree["a"]["b"],
                                                     torch.arange(6).reshape(
                                                         2, 3))
    leaf = tree["d"]
    got = tree_write_(tree, "d", torch.arange(6.0).reshape(2, 3))
    assert got is leaf and tree["d"] is leaf and not leaf.is_contiguous()
    assert leaf.tolist() == [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]]
    with pytest.raises(ValueError, match="shape"):
        tree_write_(tree, "d", torch.zeros(3, 2))
