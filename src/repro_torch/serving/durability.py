"""Crash durability for the serving engine: snapshots and a write-ahead
journal — port of the reference's ``serving/durability.py``.

  * **Snapshots** — :func:`snapshot_engine` captures the complete engine
    state at a tick boundary: the device tensors (shared cache, drafter
    cache, per-slot token / active / emitted / budget vectors) in ONE
    bulk copy (``api.cache_to_host``), the sampling generator's state, and
    the host bookkeeping (queue, resident and finished requests, per-slot
    tick budgets, every counter, the degradation-ladder mode). It rides
    ``checkpoint.save``: atomic ``step_<decode_calls>`` dirs, keep-k GC.
    The engine syncs its pending records first, so a snapshot is a
    consistent boundary and a restored run continues token-identical at
    T = 0 and on the same sampled stream at T > 0.
    :func:`restore_engine` writes everything back IN PLACE: a captured
    graph reads its tensors by address, so the caches, the per-slot
    vectors and the generator (registered with the graphs) must keep their
    storage.
  * **Write-ahead journal** — :class:`Journal`, append-only JSONL of
    ``submit`` / ``admit`` / ``commit`` / ``finish`` / ``shed`` events
    (flushed per event; a torn final line is dropped on read). Replay
    restores the latest snapshot and RESUBMITS the journal tail's accepted
    submits with their uids and deadlines; a resubmitted request
    recomputes the tokens the dead process would have produced (fp32,
    T = 0), so recovery is at-least-once delivery with no accepted request
    lost. Requests the dead process shed, expired or quarantined stay
    dead.

The snapshot holds the torch generator's state where the reference holds
its ``jax.random`` key (``rng_state``, not ``rng_key``).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch import checkpoint
from repro_torch.core.treeutil import flatten_with_path
from repro_torch.models import api as model_api

__all__ = ["Journal", "snapshot_engine", "restore_engine", "recover"]

FORMAT = 1

# engine counters captured verbatim in a snapshot and restored verbatim
_COUNTERS = (
    "decode_calls", "prefill_calls", "spec_drafted", "spec_accepted",
    "shed_count", "deadline_miss_count", "preempt_count", "poisoned_count",
    "queue_peak", "snapshots_written", "journal_events", "replayed_events",
    "integrity_probes", "heal_count",
)

# terminal statuses that stay dead across recovery: their outcome was
# already reported ("ok" finishes ARE recomputed — at-least-once delivery)
_DEAD_STATUS = ("shed", "deadline", "poisoned")


class Journal:
    """Append-only JSONL write-ahead log. One JSON object per line,
    flushed per event, opened in append mode so a recovered engine keeps
    extending the same history. ``fsync=True`` also fsyncs every append
    (durable against power loss, not just process death)."""

    def __init__(self, path: str, *, fsync: bool = False):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a")
        self._fsync = fsync

    def append(self, event: Dict[str, Any]):
        self._f.write(json.dumps(event, separators=(",", ":")) + "\n")
        self._f.flush()
        if self._fsync:
            os.fsync(self._f.fileno())

    def close(self):
        if not self._f.closed:
            self._f.close()

    @staticmethod
    def read(path: str) -> List[Dict[str, Any]]:
        """Events in order. A torn final line (a crash mid-append) is
        dropped; a torn line anywhere ends the replay there."""
        events: List[Dict[str, Any]] = []
        if not os.path.exists(path):
            return events
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    break
        return events


# --- Request (de)serialization ------------------------------------------------

def _req_to_state(r) -> Dict[str, Any]:
    return {"uid": r.uid, "prompt": list(r.prompt), "max_new": r.max_new,
            "out": list(r.out), "done": r.done, "ticks": r.ticks,
            "accept_hist": {int(k): int(v) for k, v in r.accept_hist.items()},
            "status": r.status, "deadline_at": r.deadline_at,
            "preemptions": r.preemptions, "submit_time": r.submit_time,
            "finish_time": r.finish_time}


def _req_from_state(d: Dict[str, Any]):
    from repro_torch.serving.engine import Request
    return Request(
        uid=int(d["uid"]), prompt=[int(t) for t in d["prompt"]],
        max_new=int(d["max_new"]), out=[int(t) for t in d["out"]],
        done=bool(d["done"]), ticks=int(d["ticks"]),
        # JSON stringifies int keys; undo that on the way back
        accept_hist={int(k): int(v) for k, v in d["accept_hist"].items()},
        status=str(d["status"]),
        deadline_at=None if d["deadline_at"] is None else int(d["deadline_at"]),
        preemptions=int(d["preemptions"]),
        submit_time=float(d["submit_time"]),
        finish_time=float(d["finish_time"]))


# --- snapshot / restore -------------------------------------------------------

def _compat(eng) -> Dict[str, Any]:
    return {"cfg": eng.cfg.name, "family": eng.cfg.family,
            "slots": eng.slots, "max_len": eng.max_len,
            "kv_bits": eng.kv_bits, "temperature": eng.temperature,
            "eos_id": eng.eos_id,
            "dtype": str(eng.dtype).removeprefix("torch.")}


def _device_state(eng) -> Dict[str, Any]:
    """The engine's device tensors by name, as a snapshot holds them."""
    dev = {"cache": eng.cache, "tokens": eng._tokens,
           "active": eng._active, "emitted": eng._emitted,
           "budget": eng._budget}
    if eng.spec_k:
        dev["draft_cache"] = eng.draft_cache
    return dev


def snapshot_engine(eng, snapshot_dir: str, *, keep: int = 3) -> str:
    """Persist the engine's complete state under ``snapshot_dir`` (one
    atomic ``step_<decode_calls>`` dir; the ``keep`` newest retained).
    Syncs the pending records first. Returns the path and logs a
    ``snapshot`` marker to the journal (the replay cut point)."""
    eng._sync()
    dev = model_api.cache_to_host(eng.cfg, _device_state(eng))
    # the ONLY sampling randomness of the engine: admissions and ticks draw
    # from this generator, so a restored run samples the same stream
    dev["rng_state"] = eng._gen.get_state()
    state = {
        "format": FORMAT,
        "compat": _compat(eng),
        "modes": {"spec": bool(eng.spec_k), "was_spec": eng._was_spec,
                  "spec_k": eng.spec_k, "matmul_mode": eng.matmul_mode,
                  "attn_mode": eng.attn_mode},
        "queue": [_req_to_state(r) for r in eng.queue],
        "slots": [None if r is None else _req_to_state(r)
                  for r in eng._slot_req],
        "finished": [_req_to_state(r) for r in eng._finished],
        "ticks_left": [int(x) for x in eng._ticks_left],
        "slot_ticks": [int(x) for x in eng._slot_ticks],
        "uid": eng._uid,
        "counters": {k: int(getattr(eng, k)) for k in _COUNTERS},
        "fallback_events": [[int(t), str(lbl)]
                            for t, lbl in eng.fallback_events],
    }
    path = checkpoint.save(snapshot_dir, eng.decode_calls, dev,
                           meta={"serving_state": state}, keep=keep)
    eng.snapshots_written += 1
    eng._last_snapshot_tick = eng.decode_calls
    eng._log_event({"e": "snapshot", "step": eng.decode_calls, "path": path})
    return path


def _check_compat(eng, compat: Dict[str, Any]):
    mine = _compat(eng)
    bad = [f"{k}: snapshot {compat.get(k)!r} != engine {mine[k]!r}"
           for k in mine if compat.get(k) != mine[k]]
    if bad:
        raise ValueError("snapshot is incompatible with this engine — "
                         + "; ".join(bad))


def _apply_modes(eng, modes: Dict[str, Any]):
    """Put the engine in the mode the snapshot was taken in: a degradation
    before the snapshot (spec dropped, kernels swapped for their plain
    versions) is part of the state. Each change drops the captured
    graphs."""
    if modes["spec"] and not eng.spec_k:
        raise ValueError(
            "snapshot was taken in speculative mode but this engine was "
            "built with spec_k=0 — construct it with the original spec_k")
    if modes["spec"] and modes["spec_k"] != eng.spec_k:
        raise ValueError(f"snapshot spec_k {modes['spec_k']} != engine "
                         f"spec_k {eng.spec_k}")
    if not modes["spec"] and eng.spec_k:
        eng._disable_spec()                  # the dead engine had degraded
    eng._was_spec = bool(modes["was_spec"])
    if (modes["matmul_mode"] != eng.matmul_mode
            or modes["attn_mode"] != eng.attn_mode):
        eng._set_modes(modes["matmul_mode"], modes["attn_mode"])


@torch.no_grad()
def restore_engine(eng, snapshot_dir: str,
                   step: Optional[int] = None) -> Dict[str, Any]:
    """Load a snapshot into ``eng`` (an engine with the same params and
    config). Validates compatibility loudly, replays the snapshot's
    degradation mode, and writes the device tensors and the generator
    state back in place (``api.cache_from_host`` checks structure, shape
    and dtype against the live tensors). Returns the host state."""
    dev, meta = checkpoint.restore(snapshot_dir, step)
    state = meta["serving_state"]
    if state.get("format") != FORMAT:
        raise ValueError(f"unknown snapshot format {state.get('format')!r}")
    _check_compat(eng, state["compat"])
    _apply_modes(eng, state["modes"])
    live = _device_state(eng)
    if eng.spec_k and "draft_cache" not in dev:
        raise ValueError("speculative engine but the snapshot carries no "
                         "draft cache")
    host = {k: dev[k] for k in live}
    new = model_api.cache_from_host(eng.cfg, host, like=live)
    flat_new = flatten_with_path(new)
    for path, leaf in flatten_with_path(live).items():
        leaf.copy_(flat_new[path])
    eng._gen.set_state(dev["rng_state"])
    eng._poison.zero_()
    eng._poisoned = False
    eng.queue = [_req_from_state(d) for d in state["queue"]]
    eng._slot_req = [None if d is None else _req_from_state(d)
                     for d in state["slots"]]
    eng._finished = [_req_from_state(d) for d in state["finished"]]
    eng._ticks_left = [int(x) for x in state["ticks_left"]]
    eng._slot_ticks = [int(x) for x in state["slot_ticks"]]
    eng._pending = []
    eng._uid = int(state["uid"])
    for k in _COUNTERS:
        setattr(eng, k, int(state["counters"][k]))
    eng.fallback_events = [(int(t), str(lbl))
                           for t, lbl in state["fallback_events"]]
    # a restored engine must not immediately re-snapshot the same tick
    eng._last_snapshot_tick = eng.decode_calls
    return state


# --- journal replay -----------------------------------------------------------

def recover(eng, *, snapshot_dir: Optional[str] = None,
            journal: Optional[str] = None) -> Dict[str, Any]:
    """Full recovery onto a fresh engine: restore the newest snapshot
    under ``snapshot_dir`` (if any), then replay the journal tail — every
    accepted submit recorded after that snapshot's marker whose request is
    neither in the snapshot nor terminally dead (shed / deadline /
    poisoned) is resubmitted with its uid and deadline. Returns
    ``{"restored_step", "replayed_events", "resubmitted"}``."""
    from repro_torch.serving.engine import Request
    stats = {"restored_step": None, "replayed_events": 0, "resubmitted": 0}
    step = None
    if snapshot_dir is not None:
        step = checkpoint.latest_step(snapshot_dir)
        if step is not None:
            restore_engine(eng, snapshot_dir, step)
            stats["restored_step"] = step
    if journal is None:
        return stats
    events = Journal.read(journal)
    start = 0
    if step is not None:
        for i, ev in enumerate(events):
            if ev.get("e") == "snapshot" and ev.get("step") == step:
                start = i + 1                # LAST marker for that step wins
    tail = events[start:]
    stats["replayed_events"] = len(tail)
    known = ({r.uid for r in eng.queue}
             | {r.uid for r in eng._slot_req if r is not None}
             | {r.uid for r in eng._finished})
    submits: Dict[int, Dict[str, Any]] = {}
    dead: set = set()
    order: List[int] = []
    for ev in tail:
        kind = ev.get("e")
        uid = ev.get("uid")
        if kind == "submit" and uid is not None:
            submits[uid] = ev
            order.append(uid)
        elif kind == "shed" and uid is not None:
            dead.add(uid)
        elif kind == "finish" and ev.get("status") in _DEAD_STATUS:
            dead.add(uid)
    for uid in order:
        if uid in dead or uid in known:
            continue
        ev = submits[uid]
        req = Request(uid=int(uid), prompt=[int(t) for t in ev["prompt"]],
                      max_new=int(ev["max_new"]),
                      deadline_at=(None if ev.get("deadline_at") is None
                                   else int(ev["deadline_at"])),
                      submit_time=time.perf_counter())
        eng.queue.append(req)
        stats["resubmitted"] += 1
    if submits:
        eng._uid = max(eng._uid, max(submits))
    eng.queue_peak = max(eng.queue_peak, len(eng.queue))
    eng.replayed_events += stats["replayed_events"]
    return stats
