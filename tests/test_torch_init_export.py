"""The layer-wise build (``api.init_export``) on the CPU at reduced size:
each serve tree it builds equals, bit for bit, the export of the whole
master ``init`` draws from a generator in the same state — every leaf's
dtype, shape, strides (the K-major head) and bits, for the W3A8 ``qp`` and
``q`` exports and the bf16 cast, one at a time and as a tuple from one
pass — and leaves the generator where ``init`` leaves it. The ``qp``
export matches the JAX package's ``export_container`` of the same weights
(levels and containers identical, deltas within rtol 1e-6, as
``tests/test_torch_core.py::test_export_matches_jax`` holds them), and a
drafter sliced from an export equals one exported from the master.

Configs: qwen2-1.5b (tied embedding), qwen2.5-14b (QKV bias, untied
head), qwen3-32b (qk-norm), internvl2-26b (vlm), phi3.5-moe (expert
stacks); mamba2-2.7b and zamba2-1.2b, which compose ``init`` and the
exports, in the tuple and generator cases."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import quant_dense as jqd
from repro.core.precision import W3A8 as JW3A8

from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.core.treeutil import flatten_with_path
from repro_torch.launch.serve import (build_params, export_q, export_qp,
                                      to_bf16)
from repro_torch.models import api, get_model

SEED = 11
LAYERS = 4
TRANSFORMERS = ["qwen2-1.5b", "qwen2.5-14b", "qwen3-32b", "internvl2-26b",
                "phi3.5-moe-42b-a6.6b"]
COMPOSED = ["mamba2-2.7b", "zamba2-1.2b"]
EXPORTS = {"qp": export_qp, "q": export_q, "bf16": to_bf16}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these small eager ops only lose to thread
    hand-offs when the suite's workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    return reduced(get_config(arch), layers=LAYERS)


def _gen():
    return torch.Generator().manual_seed(SEED)


@functools.lru_cache(maxsize=None)
def _master(arch):
    """The whole master of ``init`` and the generator's state after it."""
    gen = _gen()
    master = get_model(_cfg(arch)).init(gen, _cfg(arch))
    return master, gen.get_state()


def _same(got, want):
    g, w = flatten_with_path(got), flatten_with_path(want)
    assert list(g) == list(w)
    for path, ref in w.items():
        leaf = g[path]
        assert (leaf.dtype, leaf.shape, leaf.stride()) == \
            (ref.dtype, ref.shape, ref.stride()), path
        assert torch.equal(leaf, ref), path


@pytest.mark.parametrize("form", sorted(EXPORTS))
@pytest.mark.parametrize("arch", TRANSFORMERS)
def test_init_export_equals_export_of_init(arch, form):
    export = EXPORTS[form]
    _same(api.init_export(_gen(), _cfg(arch), export),
          export(_master(arch)[0]))


@pytest.mark.parametrize("arch", TRANSFORMERS + COMPOSED)
def test_tuple_form_is_each_export(arch):
    forms = sorted(EXPORTS)
    got = api.init_export(_gen(), _cfg(arch),
                          tuple(EXPORTS[f] for f in forms))
    assert isinstance(got, tuple) and len(got) == len(forms)
    for tree, form in zip(got, forms):
        _same(tree, EXPORTS[form](_master(arch)[0]))


@pytest.mark.parametrize("arch", TRANSFORMERS + COMPOSED)
def test_generator_state_after_build(arch):
    gen = _gen()
    api.init_export(gen, _cfg(arch), (export_qp, to_bf16))
    assert torch.equal(gen.get_state(), _master(arch)[1])


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "phi3.5-moe-42b-a6.6b"])
def test_qp_export_matches_jax(arch):
    """The JAX package's export_container of the master's numpy weights
    against the layer-wise build from the same seed, and against the
    port's export of those numpy weights carried back by the bridge."""
    weights = jax.tree_util.tree_map(lambda t: t.numpy(), _master(arch)[0])
    ref = flatten_with_path(jax.device_get(
        jqd.export_container(jax.tree_util.tree_map(jax.numpy.asarray,
                                                    weights), JW3A8)))
    built = api.init_export(_gen(), _cfg(arch), export_qp)
    bridged = export_qp(bridge.to_torch(weights))
    for got in (flatten_with_path(built), flatten_with_path(bridged)):
        assert sorted(got) == sorted(ref)
        for path, r in ref.items():
            g = got[path].numpy()
            assert g.shape == r.shape and g.dtype == r.dtype, path
            if path.endswith("delta"):
                np.testing.assert_allclose(g, r, rtol=1e-6, err_msg=path)
            else:
                np.testing.assert_array_equal(g, r, err_msg=path)
    assert "head" in ref or not _cfg(arch).tie_embeddings


@pytest.mark.parametrize("depth", [1.0, 0.5])
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "phi3.5-moe-42b-a6.6b"])
def test_draft_of_export_equals_draft_of_master(arch, depth):
    cfg = _cfg(arch)
    want_cfg, want = api.draft_of(cfg, _master(arch)[0],
                                  depth_fraction=depth)
    got_cfg, got = api.draft_of(
        cfg, api.init_export(_gen(), cfg, export_qp), depth_fraction=depth)
    assert got_cfg == want_cfg
    assert got_cfg.num_layers == max(1, int(LAYERS * depth))
    _same(got, want)


@pytest.mark.parametrize("depth", [1.0, 0.5])
@pytest.mark.parametrize("quant,form", [("float", "qp"), ("w3", "qp"),
                                        ("w3", "q")])
def test_build_params_drafter(quant, form, depth):
    """launch/serve.py's build: the served tree is the export of --form
    (or the bf16 cast), and the drafter — built in the same pass, or
    sliced from the served qp export — is draft_of(cfg, master)."""
    arch = "qwen2.5-14b"
    cfg = _cfg(arch)
    params, _, dcfg, dparams = build_params(
        cfg, quant=quant, form=form, seed=SEED, device="cpu", spec_k=4,
        draft_depth=depth)
    master = get_model(cfg).init(
        torch.Generator(device="cpu").manual_seed(SEED), cfg)
    _same(params, (to_bf16 if quant == "float" else EXPORTS[form])(master))
    want_cfg, want = api.draft_of(cfg, master, depth_fraction=depth)
    assert dcfg == want_cfg
    _same(dparams, want)
