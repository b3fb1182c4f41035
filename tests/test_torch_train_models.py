"""The port's training forward, per-layer deltas and loss gradients against
the JAX package on the CPU, fp32 compute, from JAX-initialised weights
bridged as numpy and the same numpy batches (JAX's ``lm_batch``), at
reduced sizes: qwen2-1.5b (dense), phi3.5-moe (MoE, aux loss),
mamba2-2.7b (ssm), zamba2-1.2b (hybrid, ``layers=5``: two groups and a
tail) and internvl2-26b (vlm, with its frontend prefix and the IGNORE
labels over it):

- ``fit_deltas_stacked``: one delta per layer per tensor, within 1e-6
  relative of JAX's;
- ``forward`` logits and aux under FLOAT and under weight-only W3 with
  JAX's own frozen deltas (``dataclasses.replace(W3A8, act_bits=None)``,
  the parity bar): within 1e-5 x max|logit|;
- the gradients of the training loss (``make_loss_fn``) against
  ``jax.grad``: every leaf within 1e-4 x its max|g|;
- ``remat="layer"`` against ``"none"`` in the port: equal gradients within
  1e-6 x max|g| (checkpointing recomputes the same ops).

One JAX reference per case is shared through ``lru_cache``d module
helpers; torch runs on one thread."""
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
from repro.data.synthetic import lm_batch as jlm_batch
from repro.models import get_model as jget_model
from repro.training.loop import make_loss_fn as jmake_loss_fn

from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.core import quant_dense
from repro_torch.core.precision import FLOAT, W3A8
from repro_torch.core.treeutil import flatten_with_path
from repro_torch.models import get_model
from repro_torch.training.loop import make_loss_fn

JW3 = dataclasses.replace(JW3A8, act_bits=None)
W3 = dataclasses.replace(W3A8, act_bits=None)
POLICIES = {"float": (JFLOAT, FLOAT), "w3": (JW3, W3)}
ARCHS = {"qwen2-1.5b": {}, "phi3.5-moe-42b-a6.6b": {}, "mamba2-2.7b": {},
         "zamba2-1.2b": dict(layers=5), "internvl2-26b": {}}
BATCH, SEQ = 4, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(jcfg, cfg, JAX master, numpy batch)."""
    jcfg = jreduced(jget_config(arch), **ARCHS[arch])
    cfg = reduced(get_config(arch), **ARCHS[arch])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    batch = jax.device_get(jlm_batch(jnp.asarray(0), jnp.asarray(3),
                                     batch=BATCH, seq=SEQ,
                                     vocab=cfg.vocab_size))
    if cfg.frontend is not None:
        rng = np.random.RandomState(0)
        batch["frontend_embeds"] = (rng.randn(
            BATCH, cfg.frontend_tokens, cfg.d_model) * 0.02).astype(np.float32)
    return jcfg, cfg, jp, batch


@functools.lru_cache(maxsize=None)
def _jdeltas(arch):
    jcfg, _, jp, _ = _model(arch)
    return jax.device_get(jqd.fit_deltas_stacked(jp, JW3A8))


def _port(arch, policy):
    """(cfg, port master, port deltas or None, torch batch)."""
    _, cfg, jp, batch = _model(arch)
    deltas = bridge.to_torch(_jdeltas(arch)) if policy == "w3" else None
    return (cfg, bridge.to_torch(jax.device_get(jp)), deltas,
            bridge.to_torch(batch))


@functools.lru_cache(maxsize=None)
def _jforward(arch, policy):
    jcfg, _, jp, batch = _model(arch)
    jpol = POLICIES[policy][0]
    deltas = _jdeltas(arch) if policy == "w3" else None
    fn = jax.jit(lambda p, b, d: jget_model(jcfg).forward(
        p, b, jcfg, policy=jpol, deltas=d, dtype=jnp.float32, remat="none"))
    logits, aux = fn(jp, batch, deltas)
    return np.asarray(logits), float(aux)


@functools.lru_cache(maxsize=None)
def _jgrads(arch, policy):
    jcfg, _, jp, batch = _model(arch)
    jpol = POLICIES[policy][0]
    deltas = _jdeltas(arch) if policy == "w3" else None
    loss_fn = jmake_loss_fn(jcfg, jpol, dtype=jnp.float32, remat="none")
    g, m = jax.jit(jax.grad(loss_fn, has_aux=True))(jp, batch, deltas)
    return jax.device_get(g), float(m["loss"])


def _port_grads(arch, policy, remat="none"):
    cfg, params, deltas, batch = _port(arch, policy)
    loss_fn = make_loss_fn(cfg, POLICIES[policy][1], dtype=torch.float32,
                           remat=remat)
    flat = {p: t.requires_grad_(True)
            for p, t in flatten_with_path(params).items()}
    total, m = loss_fn(params, batch, deltas)
    gs = torch.autograd.grad(total, list(flat.values()))
    return dict(zip(flat, gs)), float(m["loss"].detach())


@pytest.mark.parametrize("arch", list(ARCHS))
def test_fit_deltas_stacked_matches_jax(arch):
    """One delta per layer per weight ((L,), (G, A) for the hybrid's groups,
    0-d unstacked), the same leaves None as JAX's, within 1e-6 relative."""
    _, cfg, jp, _ = _model(arch)
    want = flatten_with_path(_jdeltas(arch))
    got = flatten_with_path(quant_dense.fit_deltas_stacked(
        bridge.to_torch(jax.device_get(jp)), W3A8))
    assert sorted(got) == sorted(want)
    assert any(v.ndim == 2 for v in want.values()) == (cfg.family == "hybrid")
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        np.testing.assert_allclose(got[path].numpy(), w, rtol=1e-6,
                                   err_msg=path)


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_matches_jax(arch, policy):
    """Training forward, fp32: logits within 1e-5 x max|logit| of JAX's,
    the MoE aux loss within 1e-5 relative (0 elsewhere)."""
    cfg, params, deltas, batch = _port(arch, policy)
    want, want_aux = _jforward(arch, policy)
    with torch.no_grad():
        logits, aux = get_model(cfg).forward(
            params, batch, cfg, policy=POLICIES[policy][1], deltas=deltas,
            dtype=torch.float32, remat="none")
    assert logits.dtype == torch.float32 and logits.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(logits.numpy() - want).max() <= 1e-5 * scale
    assert abs(float(aux) - want_aux) <= 1e-5 * abs(want_aux)
    assert (want_aux > 0) == (cfg.family == "moe")


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_gradients_match_jax(arch, policy):
    """Gradients of the training loss (aux mixed in, frontend labels
    IGNORE) against jax.grad, every leaf within 1e-4 x its max|g|."""
    want, want_loss = _jgrads(arch, policy)
    got, loss = _port_grads(arch, policy)
    want = flatten_with_path(want)
    assert sorted(got) == sorted(want)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for path, w in want.items():
        err = np.abs(got[path].numpy() - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-30), (path, err)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_remat_layer_equals_none(arch):
    """Checkpointing each layer recomputes the same ops: the gradients of
    remat='layer' equal remat='none' within 1e-6 x max|g|."""
    a, la = _port_grads(arch, "w3", "none")
    b, lb = _port_grads(arch, "w3", "layer")
    assert la == lb
    for path, g in a.items():
        err = float((b[path] - g).abs().max())
        assert err <= 1e-6 * max(float(g.abs().max()), 1e-30), (path, err)
