"""Host-side utilities: canonical JSON, choice indexing, id generation.

The port's copy of ``llm_weighted_consensus_tpu/utils/__init__.py``.
"""

from __future__ import annotations

import itertools
import threading
import uuid

from . import jsonutil  # noqa: F401


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1) — THE runtime R-bucketing rule.

    One definition shared by the grouped dispatch
    (models/embedder.py::consensus_confidence_tokens_many), the batcher's
    chunker (serve/batcher.py::_pow2_chunks) and the WARMUP_R snapping
    (serve/config.py): the warmup's value depends on pre-compiling exactly
    the buckets traffic hits, so the snap must never drift."""
    bucket = 1
    while bucket < n:
        bucket *= 2
    return bucket


def env_truthy(value) -> bool:
    """The framework's one definition of an env-flag truthy value."""
    return str(value).lower() in ("1", "true", "yes", "on")


class ChoiceIndexer:
    """Global choice-index allocator keyed ``(judge_index, native_index)``.

    Parity target: reference src/util.rs:5-31 (AtomicU64 + DashMap).  The
    consensus engine re-indexes every judge's native choice indices into one
    global choice space starting after the N candidate slots; allocation order
    follows chunk arrival order, exactly like the reference.  Python's GIL +
    a lock replace the lock-free structure; the allocator is also used from
    a single event loop so contention is nil.
    """

    def __init__(self, initial: int):
        self._counter = itertools.count(initial)
        self._indices: dict[tuple[int, int], int] = {}
        self._lock = threading.Lock()

    def get(self, judge_index: int, native_choice_index: int) -> int:
        key = (judge_index, native_choice_index)
        with self._lock:
            index = self._indices.get(key)
            if index is None:
                index = next(self._counter)
                self._indices[key] = index
            return index


def response_id(prefix: str, created: int) -> str:
    """``{prefix}-{uuid}-{created}`` (score client.rs:22-25 uses ``scrcpl``)."""
    return f"{prefix}-{uuid.uuid4().hex}-{created}"
