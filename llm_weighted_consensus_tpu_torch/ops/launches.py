"""Launch and route counters of the kernel wrappers, replay-aware.

Each wrapper (``kernels.cosine_vote``, ``kernels.quantize_rows``,
``kernels.w8a8_matmul``, ``kernels.w4a8_matmul``, ``attention.attention``,
``attention.segment_attention``, ``norm_act.add_layer_norm``,
``norm_act.gelu``) carries ``launches`` and, where it has
routes, ``routes`` (launches per route).  A wrapper calls ``count`` where
it launches its kernel.

A CUDA graph launches nothing while it is captured and everything it
captured at each replay, with no wrapper on the host.  So under
``recording()`` (``models.graphs`` captures inside it) ``count`` adds
nothing to the counters: it notes the launch in the recording, and
``replayed(recording)`` adds the recording's launches once per replay.
The counters then count the kernels the card ran, eager or replayed.

A kernel's output is a fresh tensor its C entry point fills: it carries
no ``grad_fn``, so a backward through it would drop the gradient into the
kernel's inputs without an error.  Each wrapper therefore calls
``refuse_grad`` before it launches: under grad mode an input that
requires grad is an error (the trainers run the attention's plain
version in torch ops, ``models/bert.py``).
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import Optional

_lock = threading.Lock()
_local = threading.local()


def refuse_grad(what: str, *tensors) -> None:
    """Raise when grad mode is on and one of ``tensors`` (None entries
    skipped) requires grad: the kernel ``what`` has no backward."""
    import torch

    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            f"{what}: an input requires grad, but the kernel defines no "
            "backward and would drop its gradient; run under "
            "torch.no_grad(), or train through the plain path "
            "(attention_impl=\"plain\", models.bert.trainable)"
        )


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
