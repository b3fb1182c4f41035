"""Overload-hardening primitives for the serving stack — port of the
reference's ``serving/resilience.py``. Nothing here touches a tensor:

  * **Bounded admission** — :class:`SubmitOutcome` (the structured
    accept/shed result of ``submit()``; an ``int`` subclass so
    ``uid = eng.submit(...)`` keeps working) and :class:`SubmitRejected`
    (a ``ValueError`` carrying a machine-readable ``reason``).
  * **Outcomes** — :data:`STATUS`, the terminal ``Request.status`` values
    (``ok`` / ``deadline`` / ``shed`` / ``poisoned``).
  * **Degradation ladder** — :func:`degrade_step` applies the next
    fallback when a tick call fails: a speculative engine drops to the
    plain tick, a kernel engine to the plain versions of the kernels. Each
    step drops the engine's captured graphs, so the next call captures
    again in the new mode (the reference re-jits).
  * **Watchdog** — :class:`WatchdogExpired`, raised by
    ``run_all(max_ticks=)`` with a diagnostic dump.
  * **Deterministic fault injection** — :class:`FaultPlan`: NaN logits,
    one-shot tick failures, admission delays, a simulated process kill and
    bit flips in the resident weights, keyed on the engine's tick counter.
"""
from __future__ import annotations

import dataclasses
import random as _random
from typing import Dict, FrozenSet, Optional, Tuple

__all__ = ["SHED_POLICIES", "STATUS", "SubmitOutcome", "SubmitRejected",
           "InjectedFault", "InjectedCrash", "WatchdogExpired", "FaultPlan",
           "degrade_step"]

SHED_POLICIES = ("reject", "drop_oldest")

# terminal Request.status values a drained request can carry
STATUS = ("ok",          # finished normally (budget or EOS)
          "deadline",    # cancelled mid-stream or in the queue past its deadline
          "shed",        # dropped by bounded admission (drop_oldest)
          "poisoned")    # quarantined: non-finite logits in its slot


class SubmitRejected(ValueError):
    """``submit()`` refused a request. ``reason`` is a machine-readable
    code (``empty_prompt`` / ``bad_max_new`` / ``too_long`` /
    ``bad_deadline``); ``ValueError`` stays the base class so callers
    catching ValueError keep working."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


class SubmitOutcome(int):
    """Structured result of ``submit()``: an ``int`` whose value is the
    accepted request's uid (uids start at 1), or 0 when the request was
    shed, so truthiness means "admitted". ``reason`` is None on acceptance
    or the shed reason (``queue_full``); ``shed`` lists uids of QUEUED
    requests evicted to make room (``drop_oldest``)."""

    accepted: bool
    reason: Optional[str]
    shed: Tuple[int, ...]

    def __new__(cls, uid: int, *, accepted: bool,
                reason: Optional[str] = None,
                shed: Tuple[int, ...] = ()):
        self = super().__new__(cls, uid)
        self.accepted = accepted
        self.reason = reason
        self.shed = tuple(shed)
        return self

    @property
    def uid(self) -> Optional[int]:
        return int(self) if self.accepted else None

    def __repr__(self):
        if self.accepted:
            extra = f", shed={self.shed}" if self.shed else ""
            return f"SubmitOutcome(uid={int(self)}{extra})"
        return f"SubmitOutcome(rejected, reason={self.reason!r})"


class InjectedFault(RuntimeError):
    """The failure :class:`FaultPlan` raises in place of a tick call: a
    distinct type so tests can tell injected faults from real ones, while
    the engine's recovery path treats both alike."""


class InjectedCrash(RuntimeError):
    """The simulated process kill ``FaultPlan.crash_at_tick`` raises from
    ``step()``, which the degradation ladder never sees. Recovery is a NEW
    engine restored from the latest snapshot plus the journal tail
    (``serving.durability.recover``)."""


class WatchdogExpired(RuntimeError):
    """``run_all(max_ticks=)`` ran out of ticks with work still queued or
    resident. ``diagnostics`` holds the queue depth, the slots and who holds
    them, and every engine counter."""

    def __init__(self, message: str, diagnostics: Dict):
        super().__init__(message)
        self.diagnostics = diagnostics


def _as_tick_slot_pairs(pairs) -> FrozenSet[Tuple[int, int]]:
    return frozenset((int(t), int(s)) for t, s in pairs)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic schedule of injected faults, keyed on the engine's
    ``decode_calls`` tick counter (admission delays are checked at the
    admission round before the tick with that index).

    ``nan_logits``      {(tick, slot), ...}: add NaN to that slot's logits
                        inside the tick, through the ``poison`` input the
                        tick always reads — the health check and quarantine.
    ``fail_ticks``      {tick, ...}: raise :class:`InjectedFault` in place
                        of the tick call, once per listed tick, before any
                        fixed buffer is touched — the degradation ladder.
    ``delay_admission`` {tick, ...}: skip the admission round at that tick —
                        queue aging (deadlines can expire while queued).
    ``crash_at_tick``   Optional[int]: raise :class:`InjectedCrash` from
                        ``step()`` at that tick — a simulated process kill;
                        everything in the engine is lost with it.
    ``flip_bits``       {(tick, path, bit), ...}: flip one bit of the params
                        leaf at tree path ``path`` (bit index in the leaf's
                        logical C order) at the start of that tick — a soft
                        error in the resident weights; the integrity probe
                        and self-heal.

    Instances are immutable; one-shot consumption lives in the engine, so a
    plan can be shared across engines and reruns."""

    nan_logits: FrozenSet[Tuple[int, int]] = frozenset()
    fail_ticks: FrozenSet[int] = frozenset()
    delay_admission: FrozenSet[int] = frozenset()
    crash_at_tick: Optional[int] = None
    flip_bits: FrozenSet[Tuple[int, str, int]] = frozenset()

    def __init__(self, nan_logits=(), fail_ticks=(), delay_admission=(),
                 crash_at_tick=None, flip_bits=()):
        object.__setattr__(self, "nan_logits",
                           _as_tick_slot_pairs(nan_logits))
        object.__setattr__(self, "fail_ticks",
                           frozenset(int(t) for t in fail_ticks))
        object.__setattr__(self, "delay_admission",
                           frozenset(int(t) for t in delay_admission))
        object.__setattr__(self, "crash_at_tick",
                           None if crash_at_tick is None
                           else int(crash_at_tick))
        object.__setattr__(self, "flip_bits",
                           frozenset((int(t), str(p), int(b))
                                     for t, p, b in flip_bits))

    def nan_slots_at(self, tick: int) -> Tuple[int, ...]:
        return tuple(sorted(s for t, s in self.nan_logits if t == tick))

    def fails_at(self, tick: int) -> bool:
        return tick in self.fail_ticks

    def delays_admission_at(self, tick: int) -> bool:
        return tick in self.delay_admission

    def crashes_at(self, tick: int) -> bool:
        return self.crash_at_tick is not None and tick == self.crash_at_tick

    def flips_at(self, tick: int) -> Tuple[Tuple[str, int], ...]:
        return tuple(sorted((p, b) for t, p, b in self.flip_bits
                            if t == tick))

    @property
    def empty(self) -> bool:
        return not (self.nan_logits or self.fail_ticks
                    or self.delay_admission or self.flip_bits
                    or self.crash_at_tick is not None)

    @classmethod
    def random(cls, seed: int, *, ticks: int, slots: int,
               nan_rate: float = 0.05, fail_rate: float = 0.05,
               delay_rate: float = 0.1) -> "FaultPlan":
        """A seeded chaos schedule over ``ticks`` x ``slots``: the
        reference's draws from Python's ``random`` in the same order, so
        the same seed gives the reference's plan."""
        rng = _random.Random(seed)
        nan, fail, delay = [], [], []
        for t in range(ticks):
            if rng.random() < nan_rate:
                nan.append((t, rng.randrange(slots)))
            if rng.random() < fail_rate:
                fail.append(t)
            if rng.random() < delay_rate:
                delay.append(t)
        return cls(nan_logits=nan, fail_ticks=fail, delay_admission=delay)


def degrade_step(engine) -> Optional[str]:
    """Apply the next degradation-ladder step to ``engine`` after a tick
    failure; returns its label, or None when the ladder is exhausted (the
    caller re-raises the failure).

      1. speculative tick -> plain tick: the drafter and its cache are
         abandoned; the target stream is unaffected (spec is exact).
      2. kernels -> their plain versions: ``matmul_mode='dequant'``,
         ``attn_mode='ref'``, the parity oracles the kernels are held
         against.

    Each step drops every captured graph; the next call captures again in
    the new mode. Engine state is untouched, which is sound because an
    injected failure raises before the tick touches a fixed buffer."""
    if engine.spec_k:
        engine._disable_spec()
        return "spec->plain"
    if engine.matmul_mode != "dequant" or engine.attn_mode != "ref":
        engine._fallback_modes()
        return "kernel->fallback"
    return None
