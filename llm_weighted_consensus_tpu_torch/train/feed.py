"""The offline feed: ledger shards and archive records into the batcher's
offline priority class.

The port's copy of ``llm_weighted_consensus_tpu/train/feed.py``:

* ``LedgerFeed`` streams ``LEDGER_DIR`` shard by shard (the rotated
  generations plus the active file, ``obs/ledger.py``), keeping the
  torn-tail skip-and-count contract per shard, so a large ledger never
  has to fit in memory at once;
* ``candidate_texts`` / ``archive_groups`` lift a stored score
  completion's candidate set (the choices with no ``model_index``, as
  ``archive/rescore.py`` defines candidates) into a re-embeddable text
  group; ``synthetic_groups`` makes deterministic groups, the
  reference's for the same seed;
* ``OfflineFeed.drive`` submits each group to the threaded
  ``DeviceBatcher`` with ``priority="offline"`` and awaits it through
  ``DeviceBatcher.wait_async``, with a bounded number of groups in
  flight.  Offline items skip the latency lane's queue-depth shed, so
  that bound is the feed's only backpressure; the batcher plans the
  latency lane first at every pipeline slot, so a latency arrival waits
  behind at most the dispatches already running.
"""

from __future__ import annotations

import asyncio
import time
from typing import Iterable, Optional

from ..obs.ledger import ledger_shard_paths, read_shard_records


class LedgerFeed:
    """Shard-streaming reader over a ledger directory."""

    def __init__(self, disk_dir: str) -> None:
        self.disk_dir = disk_dir
        self.shards_read = 0
        self.torn = 0

    def paths(self) -> list:
        return ledger_shard_paths(self.disk_dir)

    def records(self) -> Iterable[dict]:
        """Yield every record across every shard, one shard resident at
        a time; torn lines accumulate on ``self.torn``."""
        for path in self.paths():
            records, torn = read_shard_records(path)
            self.shards_read += 1
            self.torn += torn
            yield from records


def candidate_texts(completion) -> list:
    """A stored score completion's candidate texts, in index order: the
    choices without a ``model_index``; judge choices never re-embed."""
    rows = []
    for choice in completion.choices:
        if choice.model_index is not None:
            continue
        content = getattr(choice.message, "content", None)
        if isinstance(content, str) and content:
            rows.append((choice.index, content))
    return [text for _, text in sorted(rows)]


def archive_groups(store, ids: Optional[list] = None) -> Iterable[list]:
    """Candidate text groups from the archive, skipping records too
    small to vote on (the consensus dispatch needs >= 2 candidates)."""
    for cid in list(ids if ids is not None else store.score_ids()):
        completion = store.score_completion(cid)
        if completion is None:
            continue
        texts = candidate_texts(completion)
        if len(texts) >= 2:
            yield texts


def synthetic_groups(n_groups: int, n_choices: int, seed: int = 0) -> list:
    """Deterministic word-salad candidate groups for drills: saturating
    the offline lane must not depend on a populated archive."""
    words = (
        "alpha bravo charlie delta echo foxtrot golf hotel india juliet "
        "kilo lima mike november oscar papa quebec romeo sierra tango"
    ).split()
    state = seed * 2654435761 % (2**32) or 1
    groups = []
    for g in range(n_groups):
        group = []
        for c in range(n_choices):
            picks = []
            for _ in range(12):
                state = (state * 1103515245 + 12345) % (2**31)
                picks.append(words[state % len(words)])
            group.append(f"candidate {g}-{c}: " + " ".join(picks))
        groups.append(group)
    return groups


class OfflineFeed:
    """Drive candidate groups through the batcher's offline class."""

    def __init__(self, batcher, inflight: int = 4) -> None:
        self.batcher = batcher
        # groups in flight: the feed's only backpressure (offline items
        # bypass the latency lane's queue-depth shed)
        self.inflight = max(1, int(inflight))
        self.groups = 0
        self.items = 0
        self.errors = 0

    async def drive(self, groups: Iterable[list], temperature: float = 0.05):
        """Submit every group as ``consensus(priority="offline")``;
        returns ``(results, occupancy)``, where occupancy is the merged
        fraction of the drive's window the offline lane held the device
        (``DeviceBatcher.lane_occupancy``).  A failed group counts in
        ``errors`` and leaves None in its slot: the feed outlives one
        dispatch's fault."""
        batcher = self.batcher
        sem = asyncio.Semaphore(self.inflight)
        results: list = []
        tasks: list = []

        async def one(slot: int, texts: list):
            try:
                results[slot] = await batcher.wait_async(
                    batcher.submit_consensus(
                        texts, temperature, priority="offline"
                    )
                )
                self.items += len(texts)
            except Exception:
                self.errors += 1
            finally:
                sem.release()

        t0 = time.perf_counter()
        loop = asyncio.get_running_loop()
        for texts in groups:
            await sem.acquire()
            results.append(None)
            self.groups += 1
            tasks.append(loop.create_task(one(len(results) - 1, texts)))
        if tasks:
            await asyncio.gather(*tasks)
        occupancy = batcher.lane_occupancy("offline", t0)
        return results, occupancy
