"""The parts of the reference's ``serving/resilience.py`` that the port's
engine uses: structured ``submit()`` outcomes, the ``STATUS`` a finished
request carries, and :class:`FaultPlan`, the deterministic fault schedule
whose ``nan_logits`` drive the NaN quarantine. Bounded admission,
deadlines, preemption, the degradation ladder and the watchdog are not
ported yet; the engine refuses a plan that schedules the faults only they
handle."""
from __future__ import annotations

import dataclasses
from typing import FrozenSet, Optional, Tuple

__all__ = ["STATUS", "SubmitRejected", "SubmitOutcome", "FaultPlan"]

# terminal Request.status values a drained request can carry (the
# reference's "deadline" and "shed" come with bounded admission)
STATUS = ("ok",          # finished normally (budget or EOS)
          "poisoned")    # quarantined: non-finite logits in its slot


class SubmitRejected(ValueError):
    """``submit()`` refused a request. ``reason`` is a machine-readable
    code (``empty_prompt`` / ``bad_max_new`` / ``too_long``); ``ValueError``
    stays the base class so callers catching ValueError keep working."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


class SubmitOutcome(int):
    """Structured result of ``submit()``: an ``int`` whose value is the
    accepted request's uid (uids start at 1), or 0 when the request was
    shed, so ``uid = eng.submit(p)`` keeps working. ``reason`` is None on
    acceptance; ``shed`` lists uids of queued requests evicted to make
    room."""

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


def _as_tick_slot_pairs(pairs) -> FrozenSet[Tuple[int, int]]:
    return frozenset((int(t), int(s)) for t, s in pairs)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic schedule of injected faults, keyed on the engine's
    ``decode_calls`` tick counter — the reference's ``FaultPlan``.

    ``nan_logits``      {(tick, slot), ...}: add NaN to that slot's logits
                        inside the tick, through the ``poison`` input the
                        tick always reads; exercises the on-device health
                        check and the quarantine.
    ``fail_ticks``      {tick, ...}: raise in place of the tick call.
    ``delay_admission`` {tick, ...}: skip the admission round at that tick.
    ``crash_at_tick``   Optional[int]: a simulated process kill.
    ``flip_bits``       {(tick, path, bit), ...}: flip one bit of a weight.

    The port's engine serves ``nan_logits`` only: it raises
    ``NotImplementedError`` for a plan with any of the others, which need
    the degradation ladder, queue aging and durability."""

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

    @property
    def unported(self) -> Tuple[str, ...]:
        """The fields this plan sets that the port's engine cannot serve."""
        return tuple(name for name in ("fail_ticks", "delay_admission",
                                       "crash_at_tick", "flip_bits")
                     if getattr(self, name) not in (None, frozenset()))
