"""The port's NaN quarantine against the JAX engine's on the CPU, at
``reduced(qwen2-1.5b)`` (2 layers, d_model 64, vocab 128), fp32, T = 0,
from JAX-initialised weights bridged as numpy: the float master serves
(FLOAT policy), with spec_k = 2 its bridged 3-bit ``draft_of`` export
drafts. A ``FaultPlan`` puts NaN in one slot's logits at one tick, through
the ``poison`` input of the tick.

Tolerances: tokens, statuses, counts, lengths and the per-slot state
identical; cache entries within 1e-5 (fp32; the two sum in another order),
zeros exactly where the reference's are. Also the fixed-length slot map
whose padding rows are dropped on the device, against the reference's
``.at[].set(mode="drop")`` scatters."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core.precision import FLOAT as JFLOAT
from repro.models import api as japi
from repro.models import get_model as jget_model
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.resilience import FaultPlan as JFaultPlan

from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.core.graphs import index_drop_
from repro_torch.core.precision import FLOAT
from repro_torch.models import api
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.resilience import (STATUS, FaultPlan,
                                            InjectedCrash, WatchdogExpired)


@pytest.fixture(scope="module")
def models():
    """(jcfg, cfg, JAX master, port master, JAX drafter, port drafter)."""
    jcfg = jreduced(jget_config("qwen2-1.5b"))
    cfg = reduced(get_config("qwen2-1.5b"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    jdcfg, jdp = japi.draft_of(jcfg, jp)
    return (jcfg, cfg, jp, bridge.to_torch(jax.device_get(jp)), jdp,
            bridge.to_torch(jax.device_get(jdp)))


def _engines(models, spec_k, nan_logits, **kw):
    jcfg, cfg, jp, tp, jdp, dp = models
    kw = dict(slots=2, max_len=32, spec_k=spec_k, **kw)
    spec = dict(draft_params=jdp, draft_cfg=jcfg) if spec_k else {}
    jeng = JServingEngine(jp, jcfg, policy=JFLOAT, dtype=jnp.float32,
                          fault_plan=JFaultPlan(nan_logits=nan_logits),
                          **spec, **kw)
    spec = dict(draft_params=dp, draft_cfg=cfg) if spec_k else {}
    eng = ServingEngine(tp, cfg, policy=FLOAT, dtype=torch.float32,
                        fault_plan=FaultPlan(nan_logits=nan_logits),
                        device="cpu", **spec, **kw)
    return jeng, eng


def _serve(eng, prompts, max_new=6):
    uids = [int(eng.submit(p, max_new=max_new)) for p in prompts]
    by_uid = {r.uid: r for r in eng.run_all()}
    return [(by_uid[u].status, by_uid[u].out) for u in uids]


def _caches(eng):
    return [eng.cache] + ([eng.draft_cache] if eng.spec_k else [])


def _assert_caches_match(jeng, eng):
    for jc, tc in zip(_caches(jeng), _caches(eng)):
        for name, ref in jc.items():
            ref, got = np.asarray(ref, np.float32), tc[name].float().numpy()
            if name == "len":
                np.testing.assert_array_equal(got, ref)
                continue
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5,
                                       err_msg=name)
            np.testing.assert_array_equal(got == 0, ref == 0, err_msg=name)


@pytest.mark.parametrize("spec_k", [0, 2])
def test_nan_quarantine_matches_jax(models, spec_k):
    """NaN in slot 0's logits at tick 1 (the reference's
    ``test_nan_quarantine``): that request finishes "poisoned" with the
    tokens it had before the tick, its neighbour finishes "ok" with the
    tokens of a run without the fault, ``poisoned_count`` is 1, the caches
    (the quarantined rows zeroed) equal the reference's, and a new request
    reuses the slot cleanly — on both engines, identically."""
    jeng, eng = _engines(models, spec_k, [(1, 0)])
    _, clean = _engines(models, spec_k, [])
    prompts = [[1, 2, 3], [4, 5, 6]]
    ref, got = _serve(jeng, prompts), _serve(eng, prompts)
    assert got == ref
    (bad_status, bad_out), (ok_status, ok_out) = got
    healthy = _serve(clean, prompts)
    assert bad_status == "poisoned" and ok_status == "ok"
    assert 0 < len(bad_out) < 6 and bad_out == healthy[0][1][:len(bad_out)]
    assert ok_out == healthy[1][1]
    assert eng.poisoned_count == jeng.poisoned_count == 1
    _assert_caches_match(jeng, eng)
    again = [[4, 5, 6]]
    assert _serve(eng, again) == _serve(jeng, again) == [("ok", ok_out)]
    assert eng.poisoned_count == 1


@pytest.mark.parametrize("spec_k", [0, 2])
def test_poisoned_row_is_frozen_like_an_inactive_one(models, spec_k):
    """Step by step around the poisoned tick: the bad row's pending token
    and cache length are held, it is deactivated and emits nothing, while
    the other row advances; the per-slot state equals the reference's
    after every step. The plain record carries the flag, as the spec
    record does."""
    jeng, eng = _engines(models, spec_k, [(2, 1)])
    for e in (jeng, eng):
        e.submit([1, 2, 3], max_new=9)
        e.submit([7, 8, 9, 10], max_new=9)
    w = spec_k + 1
    for tick in range(4):
        jeng.step()
        eng.step()
        state = [(eng._tokens[:, 0], jeng._tokens[:, 0]),
                 (eng._active, jeng._active),
                 (eng._emitted, jeng._emitted),
                 (eng.cache["len"], jeng.cache["len"])]
        for got, ref in state:
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        bad = eng._pending[-1][0][:, w + 3].tolist()
        assert bad == ([0, 1] if tick == 2 else [0, 0]), tick
        if tick == 2:
            assert not bool(eng._active[1])
    assert all(k == "tick" for _, _, k in eng._pending[-4:])
    done = {r.uid: r for r in eng.run_all()}
    jdone = {r.uid: r for r in jeng.run_all()}
    assert [(r.status, r.out) for r in done.values()] == \
        [(jdone[u].status, jdone[u].out) for u in done]
    assert done[2].status == "poisoned" and done[1].status == "ok"
    assert set(r.status for r in done.values()) <= set(STATUS)


@pytest.mark.parametrize("field,value", [("fail_ticks", [1]),
                                         ("delay_admission", [0]),
                                         ("crash_at_tick", 3),
                                         ("flip_bits", [(0, "embed/w", 1)])])
def test_fault_plan_without_a_port_raises(models, field, value):
    """Every FaultPlan field is served now (the engine refused all but
    ``nan_logits`` before the overload and durability port): the plan is
    accepted and its fault fires — a ladder step, a simulated crash, a
    flipped bit, an admission stall that the watchdog reports. What no port can serve still raises
    where the reference raises: a flip at a path that names no leaf
    (``KeyError``, the reference's ``tree_get``)."""
    _, cfg, _, tp, _, _ = models
    plan = FaultPlan(**{field: value})
    assert not hasattr(plan, "unported") and not plan.empty
    params = {k: (dict(v) if isinstance(v, dict) else v)
              for k, v in tp.items()}
    params["embed"] = {"w": tp["embed"]["w"].clone()}
    eng = ServingEngine(params, cfg, policy=FLOAT, slots=2, max_len=32,
                        dtype=torch.float32, fault_plan=plan, device="cpu")
    eng.submit([1, 2, 3], max_new=6)
    if field == "crash_at_tick":
        with pytest.raises(InjectedCrash):
            eng.run_all()
        assert eng.decode_calls == 3
        return
    if field == "delay_admission":
        # an admission stall at tick 0 with nothing resident wedges the
        # engine at tick 0: the watchdog raises with the queue named
        with pytest.raises(WatchdogExpired) as ei:
            eng.run_all(max_ticks=5)
        assert ei.value.diagnostics["queued_uids"] == [1]
        return
    done = eng.run_all()
    assert [r.status for r in done] == ["ok"]
    if field == "fail_ticks":
        assert eng.fallback_events == [(1, "kernel->fallback")]
    else:
        diff = eng.params["embed"]["w"] != tp["embed"]["w"]
        assert diff.sum() == 1 and bool(diff[0, 0])
    bad = ServingEngine(tp, cfg, policy=FLOAT, slots=2, max_len=32,
                        fault_plan=FaultPlan(flip_bits=[(0, "embed/nope",
                                                         1)]),
                        device="cpu")
    bad.submit([1, 2, 3], max_new=2)
    with pytest.raises(KeyError, match="nope"):
        bad.step()


@pytest.mark.parametrize("kv_bits", [None, 8])
def test_fixed_slot_map_drops_like_jax(models, kv_bits):
    """``insert_prefill_many`` with a (slots,) map whose padding rows point
    past the end — several of them, beside a real row on the last slot or
    not — and ``free_slots`` with a padded index drop those rows on the
    device as the reference's ``mode="drop"`` scatters do."""
    jcfg, cfg = models[0], models[1]
    rng = np.random.default_rng(5)
    maps = [np.array([3, 4, 4, 0], np.int64), np.array([4, 1, 4, 4], np.int64),
            np.array([4, 4, 4, 4], np.int64)]
    jc = japi.init_cache(jcfg, 4, 16, jnp.float32, per_slot_len=True,
                         kv_bits=kv_bits)
    tc = api.init_cache(cfg, 4, 16, torch.float32, per_slot_len=True,
                        kv_bits=kv_bits, device="cpu")
    for slot_map in maps:
        src = {n: np.clip(rng.standard_normal((2, 4) + a.shape[2:]) * 50,
                          -120, 120).astype(np.dtype(a.dtype))
               for n, a in jc.items() if n != "len"}
        src["len"] = rng.integers(1, 16, 4).astype(np.int32)
        jc = jget_model(jcfg).insert_prefill_many(
            jc, jnp.asarray(slot_map),
            jax.tree_util.tree_map(jnp.asarray, src))
        tc = api.insert_prefill_many(cfg, tc, torch.from_numpy(slot_map),
                                     bridge.to_torch(src))
        for n in jc:
            np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]),
                                          err_msg=n)
    pad = np.array([2, 4, 4, 4], np.int32)
    jc = japi.free_slots(jcfg, jc, jnp.asarray(pad))
    tc = api.free_slots(cfg, tc, torch.from_numpy(pad))
    for n in jc:
        np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]),
                                      err_msg=n)
    assert tc["len"][2] == 0


def test_index_drop_matches_jax_drop_scatter():
    """The engine's per-slot vectors: ``index_drop_`` against
    ``.at[idx].set(v, mode="drop")`` for int, bool and (slots, 1) rows."""
    rng = np.random.default_rng(6)
    for idx in ([5, 0, 5, 2], [1, 5, 5, 5], [5, 5, 5, 5], [4, 5, 3, 5]):
        idx = np.array(idx)
        for base, val in ((rng.integers(0, 9, 5), rng.integers(10, 99, 4)),
                          (rng.random(5) < 0.5, rng.random(4) < 0.5),
                          (rng.integers(0, 9, (5, 1)),
                           rng.integers(10, 99, (4, 1)))):
            ref = jnp.asarray(base).at[idx].set(jnp.asarray(val), mode="drop")
            got = index_drop_(torch.from_numpy(base.copy()),
                              torch.from_numpy(idx), torch.from_numpy(val))
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got = index_drop_(torch.ones(5, dtype=torch.int32),
                      torch.tensor([3, 5]), 0)
    assert got.tolist() == [1, 1, 1, 0, 1]
