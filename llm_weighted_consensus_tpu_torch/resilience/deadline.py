"""Deadline propagation: one per-request time budget, ambient everywhere.

Counterpart of ``llm_weighted_consensus_tpu/resilience/deadline.py``.
The gateway's handler thread stamps a ``Deadline`` when the request
arrives (from the client's ``x-deadline-ms`` header) and activates it on
a contextvar for the rest of that thread's work on the request; the
batcher captures ``current_deadline()`` when the request submits its
device work, and sheds the item with 504 before dispatch once the budget
cannot cover the dispatch.  No deadline active: every clamp is a no-op.
"""

from __future__ import annotations

import contextvars
import time
from typing import Callable, Optional

_DEADLINE: contextvars.ContextVar = contextvars.ContextVar(
    "lwc_deadline", default=None
)


class Deadline:
    def __init__(
        self,
        seconds: float,
        *,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.clock = clock
        self._expires_at = clock() + max(0.0, float(seconds))

    def remaining(self) -> float:
        """Seconds left; never negative."""
        return max(0.0, self._expires_at - self.clock())

    def expired(self) -> bool:
        return self.clock() >= self._expires_at

    def clamp(self, timeout: Optional[float]) -> float:
        """The smaller of ``timeout`` and the remaining budget (a
        ``timeout`` of None means 'only the deadline bounds this')."""
        rem = self.remaining()
        return rem if timeout is None else min(timeout, rem)

    # -- contextvar scope -----------------------------------------------------

    def activate(self) -> contextvars.Token:
        return _DEADLINE.set(self)

    @staticmethod
    def deactivate(token: contextvars.Token) -> None:
        _DEADLINE.reset(token)


def current_deadline() -> Optional[Deadline]:
    return _DEADLINE.get()
