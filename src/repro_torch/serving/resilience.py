"""Structured ``submit()`` outcomes — the part of the reference's
``serving/resilience.py`` that the engine's admission path needs.
Bounded admission, deadlines, preemption, quarantine, the degradation
ladder and fault injection are not ported yet."""
from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["SubmitRejected", "SubmitOutcome"]


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
