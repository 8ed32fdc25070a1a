"""Persistent consensus-outcome ledger.

The port's copy of ``llm_weighted_consensus_tpu/obs/ledger.py``: one
self-describing record per scored request (panel id, per-judge votes and
weights, the confidence vector, the degraded / quorum verdict and the
trace id), kept in a bounded in-memory ring and optionally appended to a
per-process JSONL file, ``ledger-<pid>.jsonl`` (``LEDGER_RING`` /
``LEDGER_DIR``).  ``LEDGER_ROTATE_BYTES`` seals the active file under a
timestamped name (``ledger-<pid>-<ts>-<seq>.jsonl``) once it reaches
that size; every generation matches the one read glob.

There is no sampling: the ledger is the training substrate of weight
learning and archive re-scoring, and a sampled training set would bias
the learned weights.  Every offered record is kept; disk errors are
counted, never raised into the request path.  The record schema and the
file layout are the reference's, so a ledger directory either package
writes loads in the other.

The reference's ledger is mutated from one event loop only; the port's
takes one lock, as its trace sink does, since its readers (``/metrics``)
run on the gateway's handler threads.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Optional

from ..utils import jsonutil

# schema tag stamped on every record; bump on incompatible change
LEDGER_SCHEMA = "lwc.outcome.v1"


class OutcomeLedger:
    """The ring, the disk tier and its counters, under one lock."""

    def __init__(
        self,
        capacity: int = 256,
        disk_dir: Optional[str] = None,
        rotate_bytes: int = 0,
    ) -> None:
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._ring: OrderedDict = OrderedDict()
        self.kept = 0
        self._disk_path: Optional[str] = None
        self._disk_errors = 0
        # LEDGER_ROTATE_BYTES: once the active shard reaches this size
        # it is sealed under a timestamped name and a fresh active file
        # starts; 0 keeps the single ever-growing file
        self.rotate_bytes = max(0, int(rotate_bytes))
        self.rotations = 0
        self._rotate_seq = 0
        self._active_bytes = 0
        if disk_dir:
            os.makedirs(disk_dir, exist_ok=True)
            self._disk_path = os.path.join(
                disk_dir, f"ledger-{os.getpid()}.jsonl"
            )
            try:
                self._active_bytes = os.path.getsize(self._disk_path)
            except OSError:
                self._active_bytes = 0

    def _rotate(self) -> None:
        """Seal the active shard under a timestamped, size-ordered name
        that still matches the ``ledger-*.jsonl`` read glob, so
        ``load_ledger_records`` picks up every generation unchanged.
        The sequence number keeps names unique (and sorted) even when
        two rotations land inside the same second."""
        self._rotate_seq += 1
        sealed = self._disk_path[: -len(".jsonl")] + (
            f"-{int(time.time())}-{self._rotate_seq:06d}.jsonl"
        )
        try:
            os.replace(self._disk_path, sealed)
        except OSError:
            self._disk_errors += 1
            return
        self.rotations += 1
        self._active_bytes = 0

    def offer(self, record: dict) -> None:
        """Request end: keep (ring + disk) in O(1); never raises into
        the request path."""
        with self._lock:
            self._offer(record)

    def _offer(self, record: dict) -> None:
        record.setdefault("schema", LEDGER_SCHEMA)
        key = record.get("id") or f"outcome-{self.kept}"
        self.kept += 1
        self._ring[key] = record
        self._ring.move_to_end(key)
        while len(self._ring) > self.capacity:
            self._ring.popitem(last=False)
        if self._disk_path is not None:
            line = jsonutil.dumps(record) + "\n"
            try:
                with open(self._disk_path, "a", encoding="utf-8") as f:
                    f.write(line)
            except OSError:
                # the ledger must never fail the request path; the
                # error count surfaces on /metrics instead
                self._disk_errors += 1
                return
            self._active_bytes += len(line.encode("utf-8"))
            if self.rotate_bytes and self._active_bytes >= self.rotate_bytes:
                self._rotate()

    # -- read side ------------------------------------------------------------

    def index(self, limit: int = 50) -> list:
        """Recent-first records, newest first."""
        with self._lock:
            return list(reversed(self._ring.values()))[: max(1, limit)]

    def get(self, record_id: str) -> Optional[dict]:
        with self._lock:
            return self._ring.get(record_id)

    # -- observability of the observer (metrics provider "ledger") ------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "schema": LEDGER_SCHEMA,
                "capacity": self.capacity,
                "size": len(self._ring),
                "kept": self.kept,
                "disk_errors": self._disk_errors,
                "disk_path": self._disk_path,
                "rotate_bytes": self.rotate_bytes,
                "rotations": self.rotations,
            }


def ledger_shard_paths(disk_dir: str) -> list:
    """Sorted ledger shard paths under ``disk_dir`` — the sealed
    (timestamped) generations plus the active file, all matching the
    one ``ledger-*.jsonl`` glob the writer guarantees."""
    if not os.path.isdir(disk_dir):
        return []
    return sorted(
        os.path.join(disk_dir, f)
        for f in os.listdir(disk_dir)
        if f.startswith("ledger-") and f.endswith(".jsonl")
    )


def read_shard_records(path: str) -> tuple:
    """Read one shard → ``(records, torn)`` with the same torn-tail
    skip-and-count contract as ``load_ledger_records``: a replica
    killed mid-append leaves a torn final line, which is skipped and
    counted, never fatal; unreadable files count as one torn entry."""
    records = []
    torn = 0
    try:
        with open(path, encoding="utf-8") as f:
            lines = f.readlines()
    except OSError:
        return records, 1
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            record = jsonutil.loads(line)
        except ValueError:
            torn += 1
            continue
        if isinstance(record, dict):
            records.append(record)
        else:
            torn += 1
    return records, torn


def load_ledger_records(disk_dir: str) -> tuple:
    """Read back every ledger JSONL file under ``disk_dir`` —
    ``(records, torn)``.  The read side of the crash-tolerance
    contract: a replica killed mid-append leaves a torn final line,
    which is skipped and counted, never fatal — the training pipeline
    (``weights/training_table.py``) would rather lose one record than the
    archive.  Unreadable files are skipped the same way."""
    records = []
    torn = 0
    for path in ledger_shard_paths(disk_dir):
        shard_records, shard_torn = read_shard_records(path)
        records.extend(shard_records)
        torn += shard_torn
    return records, torn
