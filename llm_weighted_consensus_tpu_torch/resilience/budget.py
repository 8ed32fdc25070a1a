"""Shared retry budget: a token bucket scoped to one score request.

Without it, a browning-out upstream turns an N-judge fan-out into an
N-way retry storm: every judge independently walks the full backoff
schedule against the same sick endpoint.  The score client attaches one
``RetryBudget`` to the fan-out (via contextvar, so it flows into the
pump tasks the stream merge spawns) and the chat client's backoff loop
draws a token before every retry sleep; when the bucket is dry the
attempt fails over to the per-judge error path immediately instead of
hammering on.

An optional refill rate supports long-lived scopes (e.g. a process-wide
budget), but the per-request default is a fixed allotment — the scope
dies with the request.
"""

from __future__ import annotations

import contextvars
import time
from typing import Callable, Optional

_BUDGET: contextvars.ContextVar = contextvars.ContextVar(
    "lwc_retry_budget", default=None
)


class RetryBudget:
    def __init__(
        self,
        tokens: int,
        *,
        refill_per_sec: float = 0.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.capacity = max(0, int(tokens))
        self._tokens = float(self.capacity)
        self.refill_per_sec = float(refill_per_sec)
        self.clock = clock
        self._last = clock()
        self.denied = 0
        self.spent = 0

    def _refill(self) -> None:
        if self.refill_per_sec <= 0:
            return
        now = self.clock()
        self._tokens = min(
            float(self.capacity),
            self._tokens + (now - self._last) * self.refill_per_sec,
        )
        self._last = now

    def try_acquire(self) -> bool:
        """Spend one retry token; False when the budget is exhausted."""
        self._refill()
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            self.spent += 1
            return True
        self.denied += 1
        return False

    @property
    def remaining(self) -> int:
        self._refill()
        return int(self._tokens)

    # -- contextvar scope -----------------------------------------------------

    def activate(self) -> contextvars.Token:
        """Install as the ambient budget; tasks created while active
        inherit it (contextvars copy per task)."""
        return _BUDGET.set(self)

    @staticmethod
    def deactivate(token: contextvars.Token) -> None:
        _BUDGET.reset(token)


def current_retry_budget() -> Optional[RetryBudget]:
    return _BUDGET.get()
