"""CUDA graphs per serving bucket: the port's counterpart of the
reference's AOT executable table (``TpuEmbedder.aot_warmup``, ``_aot``,
``jit_stats`` in ``llm_weighted_consensus_tpu/models/embedder.py``).

A ``GraphTable`` belongs to one model.  ``warm(key, inputs, forward)``
captures one ``torch.cuda.CUDAGraph`` of ``forward`` at the bucket
``key`` (the reference's AOT keys: ``("vote1", n, s)``, ``("embed",
pad_b, s)``, ``("many", r, n, s)``, ``("packed", b, l, k)``, and the
reranker's ``("rm", n, s)``), over static input tensors it owns.
``dispatch`` then serves a call at that bucket in four steps, in stream
order and under the device's launch lock: copy the staged (pinned) host
rows into the static inputs with ``non_blocking`` copies, replay the
graph, run ``post`` on the static output (the vote: one launch that
takes the temperature by value, so no graph is keyed by temperature),
and start the device-to-host copy into a pinned buffer, with a CUDA
event recorded after it.  A bucket that was not warmed runs ``forward``
eagerly, the same kernels on the same card, and counts in
``eager_dispatches``.  Nothing is captured after warmup.

Where trouble lies, and what this module does about it:

* First-call attributes (``cudaFuncSetAttribute`` in each kernel's
  first launch) and tables a forward builds once on the host (the
  reward model's relative-position index) must not happen during
  capture: each bucket runs once eagerly on a side stream first.
* The TMA kernels encode their tensor maps on the host per call, so a
  graph bakes in the addresses of its inputs and intermediates: inputs
  are always copied into the graph's own static tensors, never passed
  fresh.
* Two dispatches of one bucket in flight share its static tensors: the
  launch lock covers each dispatch's copy-in, replay, vote and copy-out,
  all on one stream, so stream order keeps them apart, and each copy-out
  lands in that dispatch's own pinned buffer.
* All graphs of a model share one memory pool
  (``torch.cuda.graph_pool_handle``), so one graph's replay may write
  where another keeps its static output.  That is safe because each
  dispatch reads its graph's output (the vote, the copy-out) in stream
  order right after its own replay, before the lock lets another graph
  replay; ``pool_bytes`` reports the pool's size.
* The kernel wrappers count their launches on the host, and a replay
  calls no wrapper: each graph keeps the launches its capture noted
  (``ops.launches.recording``) and adds them at every replay.
* A capture that fails raises at warmup; nothing falls back quietly.

On the CPU nothing is captured: ``warm`` records the key, and a
dispatch at a recorded key runs the eager forward without counting as
an eager dispatch, so the bookkeeping can be held without a card.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops import launches
from .dispatch_seam import settle

_locks: Dict[str, threading.RLock] = {}
_locks_guard = threading.Lock()


def launch_lock(device) -> threading.RLock:
    """The per-device launch lock every model's dispatches hold while
    they enqueue work on the card."""
    key = str(torch.device(device))
    with _locks_guard:
        lock = _locks.get(key)
        if lock is None:
            lock = _locks[key] = threading.RLock()
        return lock


def key_label(key: tuple) -> str:
    """``("many", 8, 64, 128)`` -> ``"many(8,64,128)"``."""
    return f"{key[0]}({','.join(str(k) for k in key[1:])})"


def warm_rows(rows: int, s: int) -> dict:
    """Padded-layout warmup inputs: ids 0 and one real token per row, a
    clean forward."""
    mask = np.zeros((rows, s), np.int32)
    mask[:, 0] = 1
    return {"ids": np.zeros((rows, s), np.int32), "mask": mask}


class GraphEntry:
    """One captured bucket: its graph, static inputs and output, and the
    kernel launches its capture noted."""

    __slots__ = ("key", "graph", "inputs", "output", "launches")

    def __init__(self, key, graph, inputs, output, noted) -> None:
        self.key = key
        self.graph = graph
        self.inputs = inputs
        self.output = output
        self.launches = noted

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        launches.replayed(self.launches)
        return self.output


class Dispatch:
    """One launched dispatch: its pinned host output, the CUDA events
    recorded around it (or None), and the staging buffers it read.
    ``synchronize`` waits for it; ``result`` gives the output as numpy
    and hands the output buffer back to the pool."""

    __slots__ = ("label", "t0", "host", "events", "staged", "pool", "_value")

    def __init__(self, label, t0, host, events, staged, pool) -> None:
        self.label = label
        self.t0 = t0
        self.host = host
        self.events = events
        self.staged = staged
        self.pool = pool
        self._value = None

    def synchronize(self) -> None:
        if self.events is not None:
            self.events[1].synchronize()

    def result(self) -> np.ndarray:
        if self._value is None:
            self.synchronize()
            value = self.host.numpy()
            if self.pool is not None:
                value = value.copy()
                self.pool.release(self.host)
                self.pool = None
            self._value = value
        return self._value


class GraphTable:
    """A model's captured buckets, with their counters."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.lock = launch_lock(self.device)
        self._entries: Dict[tuple, Optional[GraphEntry]] = {}
        self._pool = None
        self.captures = 0
        self.replays = 0
        self.eager_dispatches = 0
        self.pool_bytes = 0

    # -- warmup ---------------------------------------------------------------

    def warm(
        self, key: tuple, inputs: Dict[str, np.ndarray], forward: Callable
    ) -> Optional[tuple]:
        """Capture ``forward(**static inputs)`` at ``key`` from the host
        arrays ``inputs`` (int32, the bucket's shapes; their values only
        need to make a valid forward).  -> (label, seconds), or None if
        ``key`` was warmed already."""
        with self.lock:
            if key in self._entries:
                return None
            t0 = time.perf_counter()
            if not self.on_card:
                self._entries[key] = None
                return key_label(key), time.perf_counter() - t0
            return self._capture(key, inputs, forward, t0)

    # caller-holds-lock: launch_lock.lock (only warm calls this, inside its with-lock block)
    def _capture(self, key, inputs, forward, t0) -> tuple:
        with torch.inference_mode():
            static = {
                name: torch.from_numpy(
                    np.array(a, np.int32, order="C")).to(self.device)
                for name, a in inputs.items()
            }
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                forward(**static)
            current.wait_stream(side)
            torch.cuda.synchronize(self.device)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            with launches.recording() as noted:
                with torch.cuda.graph(graph, pool=self._pool):
                    output = forward(**static)
            torch.cuda.synchronize(self.device)
            self._entries[key] = GraphEntry(key, graph, static, output, noted)
            self.captures += 1
            self.pool_bytes = self._measure_pool()
        return key_label(key), time.perf_counter() - t0

    # caller-holds-lock: launch_lock.lock (only _capture calls this)
    def _measure_pool(self) -> int:
        """Bytes of the device segments the shared graph pool holds."""
        want = tuple(self._pool)
        return sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == want
        )

    # -- dispatch -------------------------------------------------------------

    def dispatch(
        self,
        key: tuple,
        label: str,
        arrays: Dict[str, np.ndarray],
        forward: Callable,
        post: Callable,
        pool,
        timed: bool = True,
    ):
        """Stage ``arrays`` (the bucket's shapes) in ``pool`` buffers,
        then under the launch lock copy them in, replay the graph at
        ``key`` (or run ``forward`` eagerly), run ``post`` on the output
        and start the copy back; settled by ``dispatch_seam.settle``: a
        ``Dispatch`` handle under the batcher's sink, otherwise the
        output as numpy once it is ready."""
        staged = {}
        for name, a in arrays.items():
            buf = pool.acquire(a.shape, torch.int32)
            buf.numpy()[...] = a
            staged[name] = buf
        host = None
        try:
            with self.lock, torch.inference_mode():
                t0 = time.perf_counter()
                events = None
                if self.on_card:
                    events = (
                        torch.cuda.Event(enable_timing=timed),
                        torch.cuda.Event(enable_timing=timed),
                    )
                    events[0].record()
                out = post(self._run(key, staged, forward))
                if self.on_card:
                    host = pool.acquire(out.shape, out.dtype)
                    host.copy_(out, non_blocking=True)
                    events[1].record()
                    done = Dispatch(label, t0, host, events,
                                    list(staged.values()), pool)
                else:
                    done = Dispatch(label, t0, out, None,
                                    list(staged.values()), None)
        except BaseException:
            # a failed launch's pinned buffers are never freed (a sticky
            # CUDA error makes freeing one abort the process)
            for buf in [*staged.values(), *([host] if host is not None
                                            else [])]:
                pool.retain(buf)
            raise
        return settle(done, pool, timed)

    # caller-holds-lock: launch_lock.lock (only dispatch calls this, inside its with-lock block)
    def _run(self, key, staged, forward) -> torch.Tensor:
        entry = self._entries.get(key)
        if entry is not None:
            for name, buf in staged.items():
                entry.inputs[name].copy_(buf, non_blocking=True)
            self.replays += 1
            return entry.replay()
        if key not in self._entries:
            self.eager_dispatches += 1
        return forward(**{
            name: buf.to(self.device, non_blocking=True)
            for name, buf in staged.items()
        })

    # -- observability --------------------------------------------------------

    def stats(self) -> dict:
        """``graphs`` (warmed buckets), ``captures``, ``replays``,
        ``eager_dispatches`` (dispatches at buckets not warmed) and
        ``pool_bytes``, plus the warmed keys."""
        with self.lock:
            return {
                "graphs": len(self._entries),
                "captures": self.captures,
                "replays": self.replays,
                "eager_dispatches": self.eager_dispatches,
                "pool_bytes": self.pool_bytes,
                "keys": sorted(key_label(k) for k in self._entries),
            }
