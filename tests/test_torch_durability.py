"""The port's crash durability against the JAX engine's on the CPU, at
``reduced(qwen2-1.5b)`` (2 layers, d_model 64, vocab 128), fp32,
``act_bits=None``, T = 0, slots 2, max_len 32, from JAX-initialised
weights bridged as numpy (the W3 container export ``qp`` and the float
master with spec_k = 2).

Mirrors ``tests/test_durability.py`` with the JAX engine as the oracle on
the same inputs: snapshot -> restore continuations, the host state a
snapshot holds, crashes at several ticks recovered from the latest
snapshot plus the journal tail, journal-only replay, terminal requests
kept dead, a torn journal tail, the journal's event stream, the
write-ahead submit; and the checkpoint store read across packages in both
directions, bf16 leaves included. Tolerance: none — tokens, statuses,
counters, journal events, recovery stats and checkpoint bits identical."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jcheckpoint
from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import quant_dense as jquant_dense
from repro.core.precision import FLOAT as JFLOAT, W3A8 as JW3A8
from repro.models import api as japi
from repro.models import get_model as jget_model
from repro.serving.durability import Journal as JJournal
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.resilience import FaultPlan as JFaultPlan
from repro.serving.resilience import InjectedCrash as JInjectedCrash

from repro_torch import bridge, checkpoint
from repro_torch.configs import get_config, reduced
from repro_torch.core.precision import FLOAT, W3A8
from repro_torch.core.treeutil import flatten_with_path
from repro_torch.models import api
from repro_torch.serving.durability import Journal
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.resilience import FaultPlan, InjectedCrash

PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11], [20, 21, 22, 23], [30, 31],
           [40, 41, 42, 43, 44, 45], [50, 51, 52]]
MAX_NEW = [7, 5, 9, 6, 8, 4]
COUNTERS = ("decode_calls", "prefill_calls", "shed_count", "preempt_count",
            "queue_peak", "spec_drafted", "spec_accepted", "snapshots_written",
            "journal_events", "replayed_events")


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced(jget_config("qwen2-1.5b"))
    cfg = reduced(get_config("qwen2-1.5b"))
    jw3 = dataclasses.replace(JW3A8, act_bits=None)
    w3 = dataclasses.replace(W3A8, act_bits=None)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    jqp = jquant_dense.export_container(jp, jw3)
    _, jdp = japi.draft_of(jcfg, jp)
    host = lambda t: bridge.to_torch(jax.device_get(t))      # noqa: E731
    return {"cfg": (jcfg, cfg), "w": (jp, host(jp), JFLOAT, FLOAT),
            "qp": (jqp, host(jqp), jw3, w3), "draft": (jdp, host(jdp))}


def engine(models, which, form="qp", plan=None, **kw):
    """The JAX ("jax") or the port's ("torch") engine, slots 2, fp32."""
    (jcfg, cfg), (jp, tp, jpol, pol) = models["cfg"], models[form]
    kw = dict(dict(slots=2, max_len=32), **kw)
    if which == "jax":
        if kw.get("spec_k"):
            kw.update(draft_params=models["draft"][0], draft_cfg=jcfg)
        if plan:
            kw["fault_plan"] = JFaultPlan(**plan)
        return JServingEngine(jp, jcfg, policy=jpol, dtype=jnp.float32, **kw)
    if kw.get("spec_k"):
        kw.update(draft_params=models["draft"][1], draft_cfg=cfg)
    if plan:
        kw["fault_plan"] = FaultPlan(**plan)
    return ServingEngine(tp, cfg, policy=pol, dtype=torch.float32,
                         device="cpu", **kw)


def submit_all(eng):
    for p, m in zip(PROMPTS, MAX_NEW):
        eng.submit(list(p), max_new=m)


def outputs(done):
    return {r.uid: (r.status, tuple(r.out)) for r in done}


@pytest.fixture(scope="module")
def reference(models):
    """The JAX engine's uncrashed run, by form and spec_k."""
    out = {}
    for form, spec_k in (("qp", 0), ("w", 2)):
        eng = engine(models, "jax", form, spec_k=spec_k)
        submit_all(eng)
        out[form, spec_k] = outputs(eng.run_all(max_ticks=400))
    return out


def _host_state(state):
    """A snapshot's host state without the host clock stamps and the
    engine-specific compat strings."""
    def req(d):
        return None if d is None else {k: v for k, v in d.items()
                                       if not k.endswith("_time")}
    return {"queue": [req(d) for d in state["queue"]],
            "slots": [req(d) for d in state["slots"]],
            "finished": [req(d) for d in state["finished"]],
            **{k: state[k] for k in ("ticks_left", "slot_ticks", "uid",
                                     "counters", "fallback_events",
                                     "modes")}}


@pytest.mark.parametrize("form,spec_k", [("qp", 0), ("w", 2)])
def test_snapshot_restore_matches_jax(models, reference, tmp_path, form,
                                      spec_k):
    """A snapshot after 4 ticks holds the reference's host state (queue,
    resident requests mid-stream, budgets, counters, modes); a fresh port
    engine restored from it continues to the reference's uninterrupted
    output, as the donor does."""
    states = []
    for which in ("jax", "torch"):
        eng = engine(models, which, form, spec_k=spec_k)
        submit_all(eng)
        for _ in range(4):
            eng.step()
        path = eng.snapshot(str(tmp_path / which))
        with open(os.path.join(path, "meta.json")) as f:
            states.append(_host_state(json.load(f)["serving_state"]))
    assert states[1] == states[0]
    assert any(d is not None and d["out"] for d in states[1]["slots"])
    mid = outputs(eng.drain())
    donor = {**mid, **outputs(eng.run_all(max_ticks=400))}
    fresh = engine(models, "torch", form, spec_k=spec_k)
    fresh.restore(str(tmp_path / "torch"))
    assert fresh.decode_calls == 4
    restored = {**mid, **outputs(fresh.run_all(max_ticks=400))}
    assert donor == restored == reference[form, spec_k]


@pytest.mark.parametrize("field,kw", [("slots", dict(slots=3)),
                                      ("max_len", dict(max_len=48)),
                                      ("temperature", dict(temperature=0.5))])
def test_snapshot_compat_checked_loudly(models, tmp_path, field, kw):
    """Restoring onto a mismatched engine raises a ValueError naming the
    field, as the reference does."""
    eng = engine(models, "torch")
    submit_all(eng)
    eng.step()
    eng.snapshot(str(tmp_path / "s"))
    with pytest.raises(ValueError, match=field):
        engine(models, "torch", **kw).restore(str(tmp_path / "s"))


def _crash_and_recover(models, which, tmp_path, crash_at, snapshot_every):
    """Crash a journaled engine at ``crash_at`` while draining every step,
    recover a fresh one: (delivered before the crash, recovery stats,
    recovered output, the fresh engine)."""
    snaps = str(tmp_path / f"{which}-snaps")
    jpath = str(tmp_path / f"{which}-wal.jsonl")
    kw = dict(snapshot_dir=snaps, snapshot_every=snapshot_every) \
        if snapshot_every else {}
    eng = engine(models, which, journal=jpath, **kw,
                 plan=dict(crash_at_tick=crash_at))
    submit_all(eng)
    delivered = {}
    with pytest.raises((InjectedCrash, JInjectedCrash)):
        while eng.queue or eng._occupied():
            eng.step()
            delivered.update(outputs(eng.drain()))
    fresh = engine(models, which, journal=jpath,
                   **({"snapshot_dir": snaps} if snapshot_every else {}))
    stats = fresh.recover()
    return delivered, stats, outputs(fresh.run_all(max_ticks=400)), fresh


@pytest.mark.parametrize("crash_at,snapshot_every", [(1, 3), (4, 3), (9, 3),
                                                     (2, None)])
def test_crash_recovery_matches_jax(models, reference, tmp_path, crash_at,
                                    snapshot_every):
    """Kill the engine at a tick and recover a FRESH one from the latest
    snapshot plus the journal tail (or the journal alone): the recovery
    stats equal the reference's, and the union of the pre-crash drains and
    the recovered output is the uncrashed run — nothing accepted is lost,
    and what was delivered twice agrees."""
    runs = [_crash_and_recover(models, w, tmp_path, crash_at, snapshot_every)
            for w in ("jax", "torch")]
    (jdel, jstats, jrec, _), (delivered, stats, recovered, fresh) = runs
    assert stats == jstats
    assert (delivered, recovered) == (jdel, jrec)
    assert {**delivered, **recovered} == reference["qp", 0]
    for uid in set(delivered) & set(recovered):
        assert delivered[uid] == recovered[uid]
    if snapshot_every is None:
        assert stats["restored_step"] is None
        assert stats["resubmitted"] == len(PROMPTS)
        assert fresh._uid == len(PROMPTS)


def test_replay_keeps_terminal_requests_dead(models, tmp_path):
    """Requests the dead engine shed stay dead across recovery; the
    survivors come back, as in the reference."""
    queues = []
    for which in ("jax", "torch"):
        jpath = str(tmp_path / f"{which}.jsonl")
        eng = engine(models, which, journal=jpath, queue_limit=2,
                     shed_policy="drop_oldest",
                     plan=dict(crash_at_tick=1))
        submit_all(eng)
        shed = {r.uid for r in eng._finished if r.status == "shed"}
        with pytest.raises((InjectedCrash, JInjectedCrash)):
            eng.run_all(max_ticks=400)
        fresh = engine(models, which, journal=jpath)
        fresh.recover()
        queues.append([r.uid for r in fresh.queue])
        assert shed and not set(queues[-1]) & shed
    assert queues[1] == queues[0] and queues[1]


def test_journal_torn_tail_tolerated(models, tmp_path):
    """A torn final line is dropped by both readers; recovery proceeds on
    the intact prefix."""
    jpath = str(tmp_path / "wal.jsonl")
    j = Journal(jpath)
    j.append({"e": "submit", "uid": 1, "prompt": [1, 2], "max_new": 4,
              "deadline_at": None})
    j.close()
    with open(jpath, "a") as f:
        f.write('{"e": "submit", "uid": 2, "prom')   # torn write
    assert Journal.read(jpath) == JJournal.read(jpath)
    assert [e["uid"] for e in Journal.read(jpath)] == [1]
    fresh = engine(models, "torch")
    assert fresh.recover(journal=jpath)["resubmitted"] == 1
    done = fresh.run_all(max_ticks=100)
    assert [(r.uid, r.status) for r in done] == [(1, "ok")]


def test_journal_and_snapshots_match_jax(models, tmp_path):
    """snapshot_every lands the reference's snapshots (keep-3 GC); the
    journal is the reference's event stream, event for event (submit
    write-ahead with its deadline, admit, commit, finish, shed, snapshot
    markers), and the durability counters ride the diagnostics."""
    events, counters = [], []
    for which in ("jax", "torch"):
        jpath = str(tmp_path / f"{which}.jsonl")
        snaps = str(tmp_path / f"{which}-snaps")
        eng = engine(models, which, snapshot_dir=snaps, snapshot_every=2,
                     journal=jpath, queue_limit=4,
                     shed_policy="drop_oldest")
        eng.submit([9, 9, 9], max_new=3, deadline_ticks=50)
        submit_all(eng)
        eng.run_all(max_ticks=400)
        events.append([{k: v for k, v in e.items() if k != "path"}
                       for e in Journal.read(jpath)])
        counters.append({k: getattr(eng, k) for k in COUNTERS})
        assert len(jcheckpoint.all_steps(snaps)) <= 3
        if which == "torch":
            assert checkpoint.all_steps(snaps) == jcheckpoint.all_steps(
                str(tmp_path / "jax-snaps"))
            diag = eng._diagnostics()
    assert events[1] == events[0]
    assert counters[1] == counters[0]
    assert counters[1]["snapshots_written"] >= 3
    assert {"submit", "admit", "commit", "finish", "shed", "snapshot"} <= \
        {e["e"] for e in events[1]}
    assert events[1][0] == {"e": "submit", "uid": 1, "prompt": [9, 9, 9],
                            "max_new": 3, "deadline_at": 50, "tick": 0}
    for k in ("snapshots_written", "journal_events", "replayed_events",
              "integrity_probes", "heal_count"):
        assert k in diag


def test_restore_is_reproducible_at_temperature(models, tmp_path):
    """The sampling generator's state is snapshot state: two fresh engines
    restored from one mid-run snapshot sample identical streams at
    T > 0, identical to the donor's."""
    kw = dict(temperature=0.8, seed=7)
    eng = engine(models, "torch", **kw)
    submit_all(eng)
    for _ in range(4):
        eng.step()
    eng.snapshot(str(tmp_path / "s"))
    mid = outputs(eng.drain())
    donor = {**mid, **outputs(eng.run_all(max_ticks=400))}
    restored = []
    for _ in range(2):
        fresh = engine(models, "torch", **kw)
        fresh.restore(str(tmp_path / "s"))
        restored.append({**mid, **outputs(fresh.run_all(max_ticks=400))})
    assert restored[0] == restored[1] == donor


def _tree():
    """A checkpoint tree of every dtype the engine stores, bf16 included,
    as numpy (the reference's leaves after ``device_get``)."""
    rng = np.random.default_rng(3)
    return {"bf": (rng.standard_normal((3, 5)) * 7).astype(
                ml_dtypes.bfloat16),
            "n": {"f": rng.standard_normal((4, 2)).astype(np.float32),
                  "i8": rng.integers(-128, 127, (6,)).astype(np.int8),
                  "w": rng.integers(-2**31, 2**31 - 1, (2, 3),
                                    dtype=np.int64).astype(np.int32),
                  "b": rng.random(5) < 0.5,
                  "u8": rng.integers(0, 255, (7,)).astype(np.uint8)}}


def _assert_bits(got: dict, want: dict):
    for k, v in flatten_with_path(want).items():
        g = np.asarray(got[k]) if not isinstance(got[k], torch.Tensor) \
            else checkpoint._to_numpy(got[k])
        v = np.asarray(v)
        assert g.dtype.itemsize == v.dtype.itemsize and g.shape == v.shape, k
        assert g.tobytes() == v.tobytes(), k


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_read_across_packages(tmp_path, writer):
    """A step dir one package wrote, the other reads bit for bit, dtypes
    included: bf16 through the ``|V2`` words and ``_dtypes``, int8, int32,
    fp32, bool, uint8; meta round-trips and ``_dtypes`` is popped."""
    tree = _tree()
    d = str(tmp_path / "c")
    meta = {"kind": "cross", "n": 3}
    if writer == "jax":
        jcheckpoint.save(d, 7, tree, meta=meta)
        got, got_meta = checkpoint.restore(d, 7)
        assert got["bf"].dtype == torch.bfloat16
        assert got["n"]["b"].dtype == torch.bool
        _assert_bits(flatten_with_path(got), tree)
    else:
        checkpoint.save(d, 7, bridge.to_torch(tree), meta=meta)
        got, got_meta = jcheckpoint.restore(d, 7)
        assert got["bf"].dtype == jnp.bfloat16
        _assert_bits(flatten_with_path(got), tree)
        back, _ = checkpoint.restore(d)
        _assert_bits(flatten_with_path(back), tree)
    assert got_meta == {"step": 7, **meta}
    assert checkpoint.latest_step(d) == jcheckpoint.latest_step(d) == 7


def test_checkpointer_async_keeps_k(tmp_path):
    """save_async copies the tree when called (a later in-place change is
    not saved), writes in the background, and keep-k GC leaves the newest
    steps."""
    d = str(tmp_path / "a")
    ck = checkpoint.Checkpointer(d, keep=2)
    t = {"x": torch.arange(4, dtype=torch.bfloat16)}
    for step in range(4):
        ck.save_async(step, t)
        t["x"].add_(1)
    ck.wait()
    assert checkpoint.all_steps(d) == [2, 3]
    got, _ = jcheckpoint.restore(d, 3)
    assert got["x"].tolist() == [3, 4, 5, 6]


@pytest.mark.parametrize("kv_bits", [None, 8])
def test_cache_roundtrip_exact(models, tmp_path, kv_bits):
    """cache_to_host -> checkpoint -> cache_from_host is the identity on a
    live mid-run cache (fp32 or int8 K/V with its scales, per-slot len),
    and the cache equals the reference engine's at the same tick within
    1e-5 (zeros where its are); a leaf of another shape is refused."""
    engines = []
    for which in ("jax", "torch"):
        eng = engine(models, which, kv_bits=kv_bits)
        eng.submit([1, 2, 3, 4, 5], max_new=6)
        eng.submit([9, 8, 7], max_new=5)
        for _ in range(3):
            eng.step()
        eng._sync()
        engines.append(eng)
    jeng, eng = engines
    cfg = models["cfg"][1]
    host = api.cache_to_host(cfg, eng.cache)
    checkpoint.save(str(tmp_path / "c"), 0, host)
    loaded, _ = checkpoint.restore(str(tmp_path / "c"), 0)
    back = api.cache_from_host(cfg, loaded, like=eng.cache)
    for k, v in eng.cache.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
        ref = np.asarray(jax.device_get(jeng.cache[k])).astype(np.float32)
        got = v.float().numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(got == 0, ref == 0, err_msg=k)
    bad = dict(host, k=host["k"][..., :-1])
    with pytest.raises(ValueError, match="k"):
        api.cache_from_host(cfg, bad, like=eng.cache)
