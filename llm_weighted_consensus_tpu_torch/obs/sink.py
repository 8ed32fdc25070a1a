"""Completed-trace retention: bounded ring + optional JSONL disk tier.

The port's copy of ``llm_weighted_consensus_tpu/obs/sink.py``.  Head
sampling happens at the gateway door (``sample()`` is the coin the
gateway flips before building the root span); the retention decision
happens HERE at request end: a trace survives if head sampling said yes
OR something forced it (a 5xx, a shed, an error, all judges failed).
That split is what makes "always capture the bad ones" compatible with a
1% sample rate: spans are always built once a sink exists, and
``offer()`` discards the healthy unsampled majority in O(1).

The in-memory ring is an OrderedDict bounded at ``capacity`` (oldest
evicted first), served by ``GET /v1/traces`` (recent index, newest
first) and ``GET /v1/traces/{trace_id}`` (full span tree).  The disk
tier appends one self-describing JSON line per kept trace to a
per-process file, ``traces-<pid>.jsonl``.

The reference's sink is mutated from one event loop only; the port's
gateway offers traces from many handler threads, so one lock guards the
ring, the counters and the file.
"""

from __future__ import annotations

import os
import random
import threading
from collections import OrderedDict
from typing import Optional

from ..utils import jsonutil


class TraceSink:
    def __init__(
        self,
        capacity: int = 256,
        sample_rate: float = 0.0,
        disk_dir: Optional[str] = None,
        rng: Optional[random.Random] = None,
    ) -> None:
        self.capacity = max(1, int(capacity))
        self.sample_rate = float(sample_rate)
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self._ring: OrderedDict = OrderedDict()
        self.kept = 0
        self.forced = 0
        self.dropped = 0
        self._disk_path: Optional[str] = None
        self._disk_errors = 0
        if disk_dir:
            os.makedirs(disk_dir, exist_ok=True)
            self._disk_path = os.path.join(
                disk_dir, f"traces-{os.getpid()}.jsonl"
            )

    # -- head sampling -------------------------------------------------------

    def sample(self) -> bool:
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        with self._lock:
            return self._rng.random() < self.sample_rate

    # -- retention -----------------------------------------------------------

    def offer(self, trace) -> None:
        """Request end: keep (ring + disk) or drop in O(1)."""
        if not (trace.sampled or trace.forced):
            with self._lock:
                self.dropped += 1
            return
        record = trace.to_json_obj()
        line = (
            jsonutil.dumps(record) + "\n"
            if self._disk_path is not None else None
        )
        with self._lock:
            self.kept += 1
            if trace.forced:
                self.forced += 1
            self._ring[trace.trace_id] = record
            self._ring.move_to_end(trace.trace_id)
            while len(self._ring) > self.capacity:
                self._ring.popitem(last=False)
            if line is not None:
                try:
                    with open(self._disk_path, "a", encoding="utf-8") as f:
                        f.write(line)
                except OSError:
                    # tracing must never fail the request path; the error
                    # count surfaces on /metrics instead
                    self._disk_errors += 1

    # -- read side (GET /v1/traces[/{trace_id}]) -----------------------------

    def index(self, limit: int = 50) -> list:
        """Recent-first summaries (no span bodies — those are per-trace)."""
        with self._lock:
            records = list(reversed(self._ring.values()))[: max(1, limit)]
        return [
            {
                "trace_id": record["trace_id"],
                "name": record["name"],
                "started_epoch": record["started_epoch"],
                "duration_ms": record["duration_ms"],
                "status": record["status"],
                "sampled": record["sampled"],
                "forced": record["forced"],
                "force_reason": record["force_reason"],
                "spans": len(record["spans"]),
            }
            for record in records
        ]

    def get(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            return self._ring.get(trace_id)

    # -- observability of the observer (metrics provider "traces") -----------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "sample_rate": self.sample_rate,
                "capacity": self.capacity,
                "size": len(self._ring),
                "kept": self.kept,
                "forced": self.forced,
                "dropped": self.dropped,
                "disk_errors": self._disk_errors,
                "disk_path": self._disk_path,
            }
