"""Launch and route counters of the kernel wrappers, replay-aware.

Each wrapper (``kernels.cosine_vote``, ``kernels.quantize_rows``,
``kernels.w8a8_matmul``, ``kernels.w4a8_matmul``, ``attention.attention``,
``attention.segment_attention``) carries ``launches`` and, where it has
routes, ``routes`` (launches per route).  A wrapper calls ``count`` where
it launches its kernel.

A CUDA graph launches nothing while it is captured and everything it
captured at each replay, with no wrapper on the host.  So under
``recording()`` (``models.graphs`` captures inside it) ``count`` adds
nothing to the counters: it notes the launch in the recording, and
``replayed(recording)`` adds the recording's launches once per replay.
The counters then count the kernels the card ran, eager or replayed.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import Optional

_lock = threading.Lock()
_local = threading.local()


def count(wrapper, route: Optional[str] = None) -> None:
    """One launch of ``wrapper``'s kernel (on ``route``), or, inside
    ``recording()`` on this thread, one launch noted for each replay."""
    rec = getattr(_local, "recording", None)
    if rec is not None:
        rec[(wrapper, route)] += 1
        return
    with _lock:
        wrapper.launches += 1
        if route is not None:
            wrapper.routes[route] += 1


@contextlib.contextmanager
def recording():
    """Note this thread's launches instead of counting them; yields the
    ``Counter`` of (wrapper, route) -> launches that a replay adds."""
    prev = getattr(_local, "recording", None)
    rec: Counter = Counter()
    _local.recording = rec
    try:
        yield rec
    finally:
        _local.recording = prev


def replayed(rec: Counter) -> None:
    """Add one replay's launches (a ``recording()``) to the counters."""
    with _lock:
        for (wrapper, route), n in rec.items():
            wrapper.launches += n
            if route is not None:
                wrapper.routes[route] += n
