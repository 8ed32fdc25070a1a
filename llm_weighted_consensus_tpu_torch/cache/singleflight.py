"""Single-flight deduplication: concurrent same-key requests collapse
onto one in-flight computation.

The classic shape is ``do(key, factory)`` — first caller (the leader)
runs the factory, everyone else awaits the leader's future.  The score
streaming path needs the primitives underneath instead: the leader must
stream *live* to its own client while recording, so it claims the key,
streams, and completes/fails the flight when the stream finishes;
followers that arrived mid-flight await the recorded chunks and replay
them.  Both shapes share one invariant: a key's future is removed from
the table by whoever resolves it, never left to dangle.

Cancellation safety:

* a *follower* being cancelled must not disturb the flight — its wait is
  wrapped in ``asyncio.shield`` so the leader's future never absorbs a
  bystander's cancellation;
* the *leader* being cancelled (client disconnect mid-stream) fails the
  flight with ``CancelledError``; followers observe a leader-abandonment
  and retry — one of them becomes the new leader rather than all of them
  inheriting the dead leader's fate.

Single event loop assumed (the chat routes' one loop thread); no locks
needed — all table mutations happen synchronously between awaits.  The
port's copy of ``llm_weighted_consensus_tpu/cache/singleflight.py``: a
traced follower's wait is a ``singleflight:wait`` span
(``leader_abandoned`` when the leader left).
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Dict, Optional


class _Flight:
    __slots__ = ("future",)

    def __init__(self) -> None:
        self.future: asyncio.Future = asyncio.get_event_loop().create_future()


class SingleFlight:
    """Per-key in-flight computation table with a collapse counter."""

    def __init__(self) -> None:
        self._flights: Dict[str, _Flight] = {}
        self.collapses = 0  # follower joins: requests that paid no upstream

    def __len__(self) -> int:
        return len(self._flights)

    # -- primitives (streaming path) -----------------------------------------

    def claim(self, key: str) -> Optional[asyncio.Future]:
        """Become the leader for ``key`` (returns None) or get the
        current leader's future to await (counts as a collapse)."""
        flight = self._flights.get(key)
        if flight is None:
            self._flights[key] = _Flight()
            return None
        self.collapses += 1
        return flight.future

    def complete(self, key: str, value) -> None:
        """Leader hand-off: resolve every follower with ``value``."""
        flight = self._flights.pop(key, None)
        if flight is not None and not flight.future.done():
            flight.future.set_result(value)

    def fail(self, key: str, exc: BaseException) -> None:
        """Leader hand-off on error; followers re-raise ``exc`` (or, for
        CancelledError, retry as leader — see ``wait``)."""
        flight = self._flights.pop(key, None)
        if flight is not None and not flight.future.done():
            flight.future.set_exception(exc)
            # mark retrieved so a flight no follower ever awaited doesn't
            # trip the loop's "exception was never retrieved" warning
            flight.future.exception()

    async def wait(self, future: asyncio.Future):
        """Follower-side await of a leader's future, shielded so this
        caller's cancellation cannot poison the shared flight.  Returns
        ``(ok, value)``: ``ok`` False means the leader was cancelled and
        the caller should retry ``claim`` (likely becoming the leader)."""
        from ..obs import span

        with span("singleflight:wait") as s:
            try:
                return True, await asyncio.shield(future)
            except asyncio.CancelledError:
                if future.cancelled() or (
                    future.done()
                    and isinstance(
                        future.exception(), asyncio.CancelledError
                    )
                ):
                    if s is not None:
                        s.annotate(leader_abandoned=True)
                    return False, None  # leader abandoned; caller retries
                raise  # caller itself was cancelled

    # -- classic interface ---------------------------------------------------

    async def do(self, key: str, factory: Callable[[], Awaitable]):
        """Run ``factory`` once per key: leaders execute, followers await
        the leader's result.  A cancelled leader promotes a follower."""
        while True:
            future = self.claim(key)
            if future is None:
                try:
                    value = await factory()
                except BaseException as exc:
                    self.fail(key, exc)
                    raise
                self.complete(key, value)
                return value
            ok, value = await self.wait(future)
            if ok:
                return value
