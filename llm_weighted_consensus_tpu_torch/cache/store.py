"""Two-tier cache store: in-memory LRU (TTL + byte budget) over an
optional append-only JSONL disk tier.

The memory tier is the hot path: an insertion-ordered dict used as an
LRU (hits reinsert at the tail), every entry carrying its byte size and
absolute expiry.  The byte budget is enforced on insert by evicting from
the head; TTL is enforced lazily on lookup (an expired entry counts as a
miss and is dropped).

The disk tier (``SCORE_CACHE_DIR``) lets warm restarts reload previously
computed results instead of recomputing them.
Each store instance appends to its own JSONL segment (one JSON object per
line: ``{"k": fingerprint, "e": expiry, "v": value}``); on startup every
``seg-*.jsonl`` in the directory is replayed oldest-first, expired
entries skipped, and the surviving set is compacted into a fresh segment
when the old segments carry more dead weight than live data.  Eviction
never rewrites disk — the tier is append-only; compaction happens only at
load, where a full pass is already being paid.

Wall-clock time (not monotonic) keys expiry because the disk tier spans
process lifetimes.  The ``clock`` hook exists for tests.  The port's copy
of ``llm_weighted_consensus_tpu/cache/store.py``.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional


class CacheStore:
    """In-memory LRU with TTL and byte-budget accounting, plus the
    optional JSONL disk tier.  ``ttl_sec<=0`` or ``max_bytes<=0`` disables
    the store entirely (``enabled`` False, every ``get`` a pass-through
    miss that touches no state) — the TTL=0 service configuration must
    preserve cacheless behavior exactly."""

    def __init__(
        self,
        ttl_sec: float,
        max_bytes: int,
        disk_dir: Optional[str] = None,
        *,
        clock: Callable[[], float] = time.time,
        name: str = "cache",
    ) -> None:
        self.ttl_sec = float(ttl_sec)
        self.max_bytes = int(max_bytes)
        self.disk_dir = disk_dir
        self.clock = clock
        self.name = name
        self._entries: dict = {}  # fp -> [value, size, expires_at]
        self._bytes = 0
        self._segment = None  # lazily opened append handle
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.expirations = 0
        self.puts = 0
        self.disk_loaded = 0
        self.disk_torn = 0
        self.flushes = 0
        if self.enabled and disk_dir:
            self._load_disk(disk_dir)

    @property
    def enabled(self) -> bool:
        return self.ttl_sec > 0 and self.max_bytes > 0

    # -- memory tier ---------------------------------------------------------

    def get(self, fp: str):
        """The cached value, or None.  Hits refresh LRU position (not
        TTL: an entry's lifetime is anchored to when it was computed, so
        a hot stale entry still refreshes eventually)."""
        if not self.enabled:
            return None
        entry = self._entries.get(fp)
        if entry is None:
            self.misses += 1
            return None
        value, size, expires_at = entry
        if self.clock() >= expires_at:
            del self._entries[fp]
            self._bytes -= size
            self.expirations += 1
            self.misses += 1
            return None
        # LRU refresh: reinsert at the insertion-order tail
        del self._entries[fp]
        self._entries[fp] = entry
        self.hits += 1
        return value

    def put(
        self, fp: str, value, size: int, ttl_sec: Optional[float] = None
    ) -> None:
        """Insert (or refresh) ``fp``; evicts least-recently-used entries
        until the byte budget holds.  A value larger than the whole
        budget is not stored (it would evict everything for one entry
        that can never be joined by another).  ``ttl_sec`` overrides the
        store TTL for this entry (clamped to it, never extended) — the
        fleet drain handoff uses it so a transferred entry expires
        exactly when the original would have."""
        if not self.enabled or size > self.max_bytes:
            return
        if ttl_sec is not None:
            ttl_sec = min(float(ttl_sec), self.ttl_sec)
            if ttl_sec <= 0:
                return
        expires_at = self.clock() + (
            self.ttl_sec if ttl_sec is None else ttl_sec
        )
        old = self._entries.pop(fp, None)
        if old is not None:
            self._bytes -= old[1]
        self._entries[fp] = [value, int(size), expires_at]
        self._bytes += int(size)
        while self._bytes > self.max_bytes and self._entries:
            victim, (_, vsize, _) = next(iter(self._entries.items()))
            if victim == fp:
                # cannot happen (size <= max_bytes guard) unless the
                # budget shrank; never evict the entry just inserted
                break
            del self._entries[victim]
            self._bytes -= vsize
            self.evictions += 1
        if old is None:
            self.puts += 1
            self._append_disk(fp, value, expires_at)

    def holds(self, fp: str) -> bool:
        """Whether a live entry for ``fp`` is stored, without counting a
        hit or a miss or refreshing its LRU position (the fleet's lease
        guard asks before granting a lease)."""
        entry = self._entries.get(fp) if self.enabled else None
        return entry is not None and self.clock() < entry[2]

    def __len__(self) -> int:
        return len(self._entries)

    def hot_entries(self, limit: int) -> list:
        """The most-recently-used live entries, MRU first:
        ``[(fp, value, remaining_ttl_sec)]``.  The fleet drain handoff
        (fleet/coordinator.py) pushes these to their post-drain owners —
        MRU order so a bounded transfer carries the hottest keys."""
        if not self.enabled:
            return []
        now = self.clock()
        out = []
        for fp in reversed(list(self._entries)):
            value, _, expires_at = self._entries[fp]
            if expires_at <= now:
                continue
            out.append((fp, value, expires_at - now))
            if len(out) >= limit:
                break
        return out

    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "bytes": self._bytes,
            "max_bytes": self.max_bytes,
            "ttl_sec": self.ttl_sec,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "expirations": self.expirations,
            "disk_loaded": self.disk_loaded,
            "disk_torn": self.disk_torn,
            "flushes": self.flushes,
        }

    def flush(self) -> None:
        """Drain hook (serve/lifecycle.py): push the open disk segment
        through to stable storage so a graceful shutdown loses nothing
        the final requests wrote.  Each append already ``flush()``es the
        userspace buffer; this adds the fsync the per-append path
        deliberately skips (an fsync per entry would serialize the hot
        path on disk latency).  Counted in ``flushes`` — the drain
        contract is 'flushed exactly once'.  No segment open (memory-only
        store, or the disk tier degraded away) = a counted no-op, same
        accelerator-not-a-dependency stance as ``_append_disk``."""
        self.flushes += 1
        if self._segment is None:
            return
        try:
            self._segment.flush()
            os.fsync(self._segment.fileno())
        except OSError:
            self._segment = None
            self.disk_dir = None

    # -- disk tier (value codec overridden by subclasses) ---------------------

    def encode_value(self, value):
        """value -> JSON-serializable object (None = not disk-cacheable)."""
        return value

    def decode_value(self, obj):
        """JSON object -> value (raise / return None to skip the entry)."""
        return obj

    def measure(self, obj) -> int:
        """Byte-size estimate of an encoded value (the budget unit)."""
        from ..utils import jsonutil

        return len(jsonutil.dumps(obj))

    def _append_disk(self, fp: str, value, expires_at: float) -> None:
        if not self.disk_dir:
            return
        obj = self.encode_value(value)
        if obj is None:
            return
        from ..utils import jsonutil

        try:
            if self._segment is None:
                os.makedirs(self.disk_dir, exist_ok=True)
                path = os.path.join(
                    self.disk_dir, f"seg-{os.getpid()}-{id(self):x}.jsonl"
                )
                self._segment = open(path, "a", encoding="utf-8")
            self._segment.write(
                jsonutil.dumps({"k": fp, "e": expires_at, "v": obj}) + "\n"
            )
            self._segment.flush()
        except OSError:
            # the disk tier is an accelerator, never a correctness
            # dependency: a full/readonly disk degrades to memory-only
            self._segment = None
            self.disk_dir = None

    def _load_disk(self, disk_dir: str) -> None:
        from ..utils import jsonutil

        if not os.path.isdir(disk_dir):
            return
        segments = sorted(
            os.path.join(disk_dir, f)
            for f in os.listdir(disk_dir)
            if f.startswith("seg-") and f.endswith(".jsonl")
        )
        if not segments:
            return
        now = self.clock()
        loaded: dict = {}  # fp -> (value, size, expires_at); later wins
        lines = 0
        for path in segments:
            try:
                with open(path, encoding="utf-8") as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        lines += 1
                        try:
                            rec = jsonutil.loads(line)
                            if now >= float(rec["e"]):
                                continue
                            value = self.decode_value(rec["v"])
                            if value is None:
                                continue
                            loaded[rec["k"]] = (
                                value,
                                self.measure(rec["v"]),
                                float(rec["e"]),
                            )
                        except (ValueError, KeyError, TypeError):
                            # torn tail write (kill -9 mid-append) or a
                            # foreign line: skipped and COUNTED — a torn
                            # record is expected crash debris, not a
                            # reason to fail the whole segment load
                            self.disk_torn += 1
                            continue
            except OSError:
                continue
        for fp, (value, size, expires_at) in loaded.items():
            if size > self.max_bytes:
                continue
            self._entries[fp] = [value, size, expires_at]
            self._bytes += size
            self.disk_loaded += 1
        while self._bytes > self.max_bytes and self._entries:
            victim, (_, vsize, _) = next(iter(self._entries.items()))
            del self._entries[victim]
            self._bytes -= vsize
        # compact when the segments hold more dead lines than live
        # entries: rewrite survivors into one fresh segment and drop the
        # old files (load already paid the full read)
        if lines > 2 * len(self._entries):
            try:
                compact = os.path.join(
                    disk_dir, f"seg-{os.getpid()}-{id(self):x}-c.jsonl"
                )
                with open(compact, "w", encoding="utf-8") as f:
                    for fp, (value, _, expires_at) in self._entries.items():
                        obj = self.encode_value(value)
                        if obj is None:
                            continue
                        f.write(
                            jsonutil.dumps(
                                {"k": fp, "e": expires_at, "v": obj}
                            )
                            + "\n"
                        )
                for path in segments:
                    os.unlink(path)
            except OSError:
                pass


class ScoreCache(CacheStore):
    """Fingerprint -> recorded score-stream chunk frames.

    The stored value is the *wire form*: the list of chunk JSON objects
    the stream yielded (cache/replay.py records and replays them), so a
    hit reproduces the exact frames of the original response — unary
    callers fold the same chunks the streaming path replays.  Values are
    plain JSON objects (typed chunks are decoded per replay, so no caller
    can mutate the cached copy), which makes the disk codec the identity.
    """

    def __init__(
        self,
        ttl_sec: float,
        max_bytes: int,
        disk_dir: Optional[str] = None,
        *,
        clock: Callable[[], float] = time.time,
    ) -> None:
        super().__init__(
            ttl_sec, max_bytes, disk_dir, clock=clock, name="score_cache"
        )

    def put_chunks(
        self, fp: str, chunk_objs: list, ttl_sec: Optional[float] = None
    ) -> None:
        # the recording leader's trace_id must not leak into replays: a
        # cache hit is a different request with (usually) no trace, and a
        # stale id pointing at the leader's span tree would mislead more
        # than it helps — cached responses simply carry no trace_id
        for obj in chunk_objs:
            obj.pop("trace_id", None)
        self.put(fp, chunk_objs, self.measure(chunk_objs), ttl_sec)

    def decode_value(self, obj):
        return obj if isinstance(obj, list) else None


class EmbeddingCache(CacheStore):
    """Row fingerprint -> ``(embedding vector, token count)``.

    Memory-only: vectors are recomputed cheaply relative to their JSONL
    footprint, and the batcher's win is collapsing *hot* rows before
    device dispatch, which the memory tier alone delivers."""

    def __init__(
        self,
        ttl_sec: float,
        max_bytes: int,
        *,
        clock: Callable[[], float] = time.time,
    ) -> None:
        super().__init__(
            ttl_sec, max_bytes, None, clock=clock, name="embed_cache"
        )

    def put_row(self, fp: str, vector, tokens: int) -> None:
        # vector is a host numpy row; nbytes + key/bookkeeping overhead
        self.put(fp, (vector, int(tokens)), int(vector.nbytes) + 64)

    def encode_value(self, value):
        return None  # never written to disk
