"""The port's distributed layer against the JAX reference, on the CPU, in
one process:

- ``sharding``: for every arch and the meshes 16x16, 2x16x16, 2x4 and
  4x2 (shape-only meshes, as the reference's own sharding tests use),
  ``param_specs`` (fsdp on and off) on the train, prefill and decode
  templates, ``state_specs``, ``batch_specs``, ``activation_rules`` and
  ``cache_specs`` (bf16 and int8 KV) equal the reference's leaf by leaf,
  and the port's templates (built on the ``meta`` device) have the
  reference's leaf shapes and dtypes (``jax.eval_shape``);
- ``compression``: ``quantize_grad``'s levels and scale and the error
  feedback's compressed gradients and residuals equal JAX's bit for bit;
  the feedback identity holds; a reduced qwen2 train step with the
  compressor tracks the reference's losses over 10 steps;
- ``context``: ``constrain`` is a no-op outside a rules context and on
  plain tensors; the guard drops an axis of size 1 or one that does not
  divide its dim.

The multi-rank behaviour (placements, collectives, the pipeline, the
cells on a mesh) is in ``tests/test_torch_multirank.py``.
"""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import LM_SHAPES as JLM_SHAPES
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core.precision import FLOAT as JFLOAT
from repro.core.treeutil import flatten_with_path as jflatten
from repro.data.synthetic import lm_batch as jlm_batch
from repro.distributed import compression as jcomp
from repro.distributed import sharding as jshd
from repro.launch import steps as jsteps
from repro.models import get_model as jget_model
from repro.training.loop import make_train_step as jmake_train_step

from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, LM_SHAPES, TrainConfig, get_config
from repro_torch.configs import reduced
from repro_torch.core.precision import FLOAT
from repro_torch.core.treeutil import flatten_with_path
from repro_torch.distributed import compression, context
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps
from repro_torch.training.loop import make_train_step

MESHES = {"16x16": dict(data=16, model=16),
          "2x16x16": dict(pod=2, data=16, model=16),
          "2x4": dict(data=2, model=4), "4x2": dict(data=4, model=2)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- templates and specs -------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jparams(arch, kind):
    return jsteps._params_template(jget_config(arch), "w3", kind)


@functools.lru_cache(maxsize=None)
def _jstate(arch):
    return jsteps._state_template(jget_config(arch), JTrainConfig(), "w3")


@functools.lru_cache(maxsize=None)
def _jcache(arch, shape_name, kv8):
    shape = next(s for s in JLM_SHAPES if s.name == shape_name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jsteps._cache_template(jget_config(arch), shape, kv8=kv8)


@functools.lru_cache(maxsize=None)
def _params(arch, kind):
    return steps._params_template(get_config(arch), "w3", kind)


@functools.lru_cache(maxsize=None)
def _state(arch):
    return steps._state_template(get_config(arch), TrainConfig(), "w3")


@functools.lru_cache(maxsize=None)
def _cache(arch, shape_name, kv8):
    shape = next(s for s in LM_SHAPES if s.name == shape_name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return steps._cache_template(get_config(arch), shape, kv8=kv8)


def _norm(spec):
    """A spec as a plain tuple, a one-name tuple entry read as the name."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in tuple(spec))


def _same_specs(want, got, what):
    w = {k: _norm(v) for k, v in jflatten(want).items()}
    g = {k: _norm(v) for k, v in flatten_with_path(got).items()}
    assert sorted(w) == sorted(g), (what, sorted(set(w) ^ set(g)))
    bad = [(k, w[k], g[k]) for k in w if w[k] != g[k]]
    assert not bad, (what, bad[:5])


def _same_leaves(want, got, what):
    w = {k: (tuple(v.shape), str(np.dtype(v.dtype)))
         for k, v in jflatten(want).items()}
    g = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
         for k, v in flatten_with_path(got).items()}
    assert w == g, (what, [(k, w.get(k), g.get(k)) for k in set(w) | set(g)
                           if w.get(k) != g.get(k)][:5])
    assert all(v.is_meta for v in flatten_with_path(got).values()), what


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_and_templates_match_reference(arch, mesh_name):
    cfg, jcfg = get_config(arch), jget_config(arch)
    mesh = shd.ShapeMesh(**MESHES[mesh_name])
    for kind in ("train", "prefill", "decode"):
        jt, pt = _jparams(arch, kind), _params(arch, kind)
        _same_leaves(jt, pt, f"{kind} params")
        for fsdp in (False, True) if kind == "train" else (False,):
            _same_specs(jshd.param_specs(jcfg, jt, mesh, fsdp=fsdp),
                        shd.param_specs(cfg, pt, mesh, fsdp=fsdp),
                        f"{kind} param_specs fsdp={fsdp}")
    jst, st = _jstate(arch), _state(arch)
    _same_leaves(jst, st, "train state")
    for fsdp in (False, True):
        _same_specs(jshd.state_specs(jcfg, jst, mesh, fsdp=fsdp),
                    shd.state_specs(cfg, st, mesh, fsdp=fsdp),
                    f"state_specs fsdp={fsdp}")
    for jshape, shape in zip(JLM_SHAPES, LM_SHAPES):
        jb, b = jsteps.input_specs(jcfg, jshape), steps.input_specs(cfg, shape)
        _same_leaves(jb, b, f"{shape.name} inputs")
        _same_specs(jshd.batch_specs(jcfg, jshape, mesh, jb),
                    shd.batch_specs(cfg, shape, mesh, b),
                    f"{shape.name} batch_specs")
        _same_specs(jshd.activation_rules(jcfg, jshape, mesh),
                    shd.activation_rules(cfg, shape, mesh),
                    f"{shape.name} activation_rules")
        if shape.kind != "decode":
            continue
        for kv8 in (False, True):
            jc, c = _jcache(arch, shape.name, kv8), _cache(arch, shape.name,
                                                           kv8)
            _same_leaves(jc, c, f"{shape.name} cache kv8={kv8}")
            _same_specs(jshd.cache_specs(jcfg, jshape, mesh, jc),
                        shd.cache_specs(cfg, shape, mesh, c),
                        f"{shape.name} cache_specs kv8={kv8}")


def test_production_meshes_need_their_worlds():
    """Without a process group the meshes raise a clear error (the
    reference's production meshes raise without their devices; the
    multi-rank test holds a group of the wrong size), and a CUDA mesh
    without a card raises."""
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    for fn in (lambda: make_production_mesh(device="cpu"),
               lambda: make_production_mesh(multi_pod=True, device="cpu"),
               lambda: make_host_mesh(device="cpu")):
        with pytest.raises(RuntimeError, match="process group"):
            fn()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make_host_mesh()


# --- compression ---------------------------------------------------------------

GRADS = {"normal": lambda g: g.standard_normal((1000,)).astype(np.float32),
         "matrix": lambda g: (g.standard_normal((64, 33)) * 1e-3)
         .astype(np.float32),
         "zeros": lambda g: np.zeros((16,), np.float32),
         "tiny": lambda g: (g.standard_normal((40,)) * 1e-30)
         .astype(np.float32),
         "ties": lambda g: (np.arange(-20, 21) / 20 * 127 / 2)
         .astype(np.float32)}


def _bits(x) -> np.ndarray:
    return np.asarray(x).reshape(-1).view(np.uint8)


@pytest.mark.parametrize("name", sorted(GRADS))
def test_quantize_grad_bit_identical(name):
    g = GRADS[name](np.random.default_rng(7))
    jq, js = jcomp.quantize_grad(jnp.asarray(g))
    q, s = compression.quantize_grad(torch.from_numpy(g))
    assert q.dtype == torch.int8 and q.shape == g.shape
    assert np.array_equal(np.asarray(jq), q.numpy())
    assert np.array_equal(_bits(np.float32(js)), _bits(s.numpy()))
    assert np.array_equal(
        _bits(np.asarray(jcomp.dequantize_grad(jq, js))),
        _bits(compression.dequantize_grad(q, s).numpy()))


def test_error_feedback_matches_jax_and_sums_to_truth():
    """Step by step the compressed gradients and residuals equal JAX's bit
    for bit, and (the reference's test) the compressed sum plus the last
    residual is the true sum."""
    jtf, tf = jcomp.make_grad_compressor(), compression.make_grad_compressor()
    rng = np.random.default_rng(0)
    jstate = {}
    state = {"ef": compression.init_error_feedback(
        {"w": torch.zeros(64), "b": torch.zeros(3, 5)})}
    true_sum = np.zeros(64, np.float32)
    comp_sum = torch.zeros(64)
    for _ in range(20):
        g = {"w": (rng.standard_normal(64) * 0.1).astype(np.float32),
             "b": rng.standard_normal((3, 5)).astype(np.float32)}
        jg, jstate = jtf(jax.tree_util.tree_map(jnp.asarray, g), jstate)
        tg, state = tf({k: torch.from_numpy(v) for k, v in g.items()}, state)
        for k in g:
            assert np.array_equal(_bits(np.asarray(jg[k])), _bits(tg[k]))
            assert np.array_equal(_bits(np.asarray(jstate["ef"][k])),
                                  _bits(state["ef"][k]))
        true_sum += g["w"]
        comp_sum += tg["w"]
    np.testing.assert_allclose((comp_sum + state["ef"]["w"]).numpy(),
                               true_sum, atol=1e-4)
    with pytest.raises(ValueError, match="init_error_feedback"):
        tf({"w": torch.zeros(2)}, {})


COMP_TCFG = dict(learning_rate=3e-3, total_steps=30, warmup_steps=3)
# 10 steps through int8 gradients: an fp32 rounding difference in a
# gradient can move a value across a rounding boundary of g / scale, one
# level (scale = max|g| / 127), and the step's trajectory drifts by that
COMP_LOSS_TOL = 1e-4


def test_compressed_train_step_tracks_jax():
    kw = dict(layers=2, d_model=32, vocab=64)
    jcfg, cfg = jreduced(jget_config("qwen2-1.5b"), **kw), \
        reduced(get_config("qwen2-1.5b"), **kw)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    jstep, jinit = jmake_train_step(jcfg, JTrainConfig(**COMP_TCFG), JFLOAT,
                                    dtype=jnp.float32,
                                    grad_transform=jcomp.make_grad_compressor())
    step, init = make_train_step(cfg, TrainConfig(**COMP_TCFG), FLOAT,
                                 dtype=torch.float32,
                                 grad_transform=compression
                                 .make_grad_compressor())
    jstate = jinit(jp)
    jstate["ef"] = None                                  # made lazily
    params = bridge.to_torch(jax.device_get(jp))
    state = init(params, extra={"ef": compression.init_error_feedback(
        params)})
    jstep = jax.jit(jstep)
    for i in range(10):
        batch = jax.device_get(jlm_batch(jnp.asarray(0), jnp.asarray(i),
                                         batch=8, seq=16, vocab=64))
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, bridge.to_torch(batch))
        want, got = float(jm["loss"]), float(m["loss"])
        assert abs(got - want) <= COMP_LOSS_TOL * abs(want), (i, got, want)
    assert int(state["step"]) == 10
    ef = flatten_with_path(state["ef"])
    jef = jflatten(jstate["ef"])
    assert sorted(ef) == sorted(jef)
    assert any(float(v.abs().max()) > 0 for v in ef.values())


# --- context -------------------------------------------------------------------

def test_constrain_is_a_no_op_outside_a_mesh():
    x = torch.randn(4, 6, 8)
    assert context.constrain(x, "act") is x
    mesh = shd.ShapeMesh(data=2, model=4)
    with context.sharding_rules({"act": shd.P("data", None, None),
                                 "__mesh__": mesh}):
        assert context.constrain(x, "act") is x          # a plain tensor
        assert context.constrain(x, "not_a_rule") is x
    assert context.constrain(x, "act") is x


def test_constrain_guard_drops_axes_that_do_not_divide():
    mesh = shd.ShapeMesh(pod=2, data=16, model=16)
    spec = shd.P(("pod", "data"), None, "model")
    assert context.guarded((64, 7, 32), spec, mesh) == [("pod", "data"),
                                                         None, "model"]
    assert context.guarded((8, 7, 48), spec, mesh) == [None, None, "model"]
    assert context.guarded((64, 7, 40), spec, mesh) == [("pod", "data"),
                                                         None, None]
    # a size-1 axis shards nothing; missing trailing entries are None
    one = shd.ShapeMesh(data=1, model=1)
    assert context.guarded((8, 4), shd.P("data"), one) == [None, None]


def test_cost_exact_flag():
    assert not context.is_cost_exact() and not context.inner_unroll()
    with context.cost_exact_mode():
        assert context.is_cost_exact() and context.inner_unroll()
    assert not context.is_cost_exact()


def test_placements_follow_the_spec():
    """``placements`` reads a spec on a named mesh: ``Shard(d)`` on each
    mesh dim a tensor dim names (a tuple of names data major), else
    ``Replicate``, and ``Replicate`` on a mesh dim of size 1; a tuple
    against the mesh's order is refused."""
    from torch.distributed.tensor import Replicate, Shard

    class Named:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)

    m = Named()
    assert shd.placements(m, shd.P(("pod", "data"), None, "model")) == \
        [Shard(0), Shard(0), Shard(2)]
    assert shd.placements(m, shd.P(None, ("data", "model"))) == \
        [Replicate(), Shard(1), Shard(1)]
    assert shd.placements(m, shd.P()) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh's order"):
        shd.placements(m, shd.P(("model", "data")))

    class One:                        # a (1, 1) mesh: one device holds all
        mesh_dim_names = ("data", "model")
        shape = (1, 1)

    assert shd.placements(One(), shd.P("data", None, "model")) == \
        [Replicate(), Replicate()]


def test_fsdp_threshold_and_microbatches():
    mesh = shd.ShapeMesh(data=16, model=16)
    assert steps.FSDP_THRESHOLD == jsteps.FSDP_THRESHOLD
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        for jshape, shape in zip(JLM_SHAPES, LM_SHAPES):
            assert steps._default_microbatches(cfg, shape, mesh) == \
                jsteps._default_microbatches(jcfg, jshape, mesh)
        assert (cfg.param_count() >= steps.FSDP_THRESHOLD) == \
            (jcfg.param_count() >= jsteps.FSDP_THRESHOLD)


def test_meta_templates_allocate_nothing():
    """A full-size cell's templates are meta tensors: qwen2.5-14b's
    train state (59 GB of fp32 master, moments and deltas) builds in no
    memory."""
    cfg = get_config("qwen2.5-14b")
    st = steps._state_template(cfg, TrainConfig(), "w3")
    leaves = flatten_with_path(st)
    assert all(v.is_meta for v in leaves.values())
    n = sum(v.numel() for v in flatten_with_path(st["params"]).values())
    assert n > 1.4e10
    cell_cfg = dataclasses.replace(cfg, num_layers=2)
    assert steps._params_template(cell_cfg, "w3", "decode")["layers"][
        "attn"]["wq"]["qp"].is_meta
