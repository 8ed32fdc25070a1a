"""A small micro-batcher in front of the device.

Counterpart, in part, of ``llm_weighted_consensus_tpu/serve/batcher.py``'s
``DeviceBatcher``: concurrent requests of the same kind coalesce into one
device dispatch.  One worker thread owns the device; callers block on a
``concurrent.futures.Future`` that the worker resolves.

* Padded (the default): consensus requests group by ``(N, temperature)``
  and run ``consensus_confidence_tokens_many``; embedding requests group
  together and run ``embed_tokens``.
* Packed (``packing=True``, ``PACKING_ENABLED``): every request groups
  under one key, capped by its estimated segments (``packing_max_rows``
  x ``packing_max_segments``).  The group's texts are laid end to end in
  rows of ``packing_row_tokens`` (``serve/packing.py``) and embedded by
  one ``embed_packed`` per packed call; embedding requests gather their
  vectors, consensus requests of any N and temperature vote on the host
  (``packing.consensus_vote_np``).  With ``prefix_dedup`` a consensus
  request whose candidates share a prefix of at least
  ``prefix_dedup_min_chars`` embeds it once and composes each candidate
  from its prefix and suffix vectors (``packing.compose_prefix_suffix``,
  the reference's defined contract).

Submit-time planning on a host pool, admission control, priority lanes,
deadlines and the watchdog of the reference's batcher are later slices
(ROADMAP.md).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Optional

import numpy as np

from ..models.embedder import _bucket, next_pow2
from . import packing as _packing

log = logging.getLogger("lwc.torch.batcher")

PACKED_KEY = ("packed",)


class _Item:
    __slots__ = ("kind", "key", "payload", "future", "t_enq")

    def __init__(self, kind, key, payload):
        self.kind = kind  # "consensus" or "embed"
        self.key = key
        # consensus: (texts, temperature); embed: texts
        self.payload = payload
        self.future: Future = Future()
        self.t_enq = time.perf_counter()

    @property
    def texts(self) -> list:
        return self.payload[0] if self.kind == "consensus" else self.payload


class ConsensusBatcher:
    """Coalesces same-key requests into one dispatch.  A padded group
    holds at most ``max_batch`` requests; a packed group at most
    ``packing_max_rows * packing_max_segments`` estimated segments (one
    per text, the first request always fits).  A group leaves when it is
    full or when its oldest request has waited ``max_wait_ms``.
    ``close()`` stops the worker."""

    def __init__(
        self,
        embedder,
        max_batch: int = 16,
        max_wait_ms: float = 2.0,
        *,
        packing: bool = False,
        packing_row_tokens: int = 512,
        packing_max_rows: int = 8,
        packing_max_segments: int = 64,
        prefix_dedup: bool = True,
        prefix_dedup_min_chars: int = 48,
    ) -> None:
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.embedder = embedder
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        # the reference's clamps (serve/config.py)
        self.packing = bool(packing) and bool(
            getattr(embedder, "supports_packing", lambda: False)()
        )
        self.packing_row_tokens = max(16, int(packing_row_tokens))
        self.packing_max_rows = max(1, int(packing_max_rows))
        self.packing_max_segments = max(1, int(packing_max_segments))
        self.prefix_dedup = bool(prefix_dedup)
        self.prefix_dedup_min_chars = max(1, int(prefix_dedup_min_chars))
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._closed = False
        # counters, read by stats(); guarded by _cond (the worker thread
        # writes the token counters, stats() reads them from others)
        self._dispatches = {"consensus": 0, "embed": 0}
        self._requests = {"consensus": 0, "embed": 0}
        self._largest_group = 0
        self._packed_dispatches = 0
        self._pack_real_tokens = 0
        self._pack_slot_tokens = 0
        self._pad_real_tokens = 0
        self._pad_slot_tokens = 0
        self._dedup_hits = 0
        self._dedup_tokens_saved = 0
        self._fallback_items = 0
        self._occupancy: dict = {}  # packed call rows B -> calls
        self._call_shapes: dict = {}  # "BxL" -> packed calls
        self._worker = threading.Thread(
            target=self._run, name="lwc-torch-device", daemon=True
        )
        self._worker.start()

    # -- caller side ---------------------------------------------------------

    def submit_consensus(self, texts, temperature: float = 0.05) -> Future:
        """-> Future of (confidence[N] np.ndarray, prompt token count)."""
        texts = list(texts)
        key = (
            PACKED_KEY if self.packing
            else ("consensus", len(texts), float(temperature))
        )
        return self._submit("consensus", key, (texts, float(temperature)))

    def submit_embed(self, texts) -> Future:
        """-> Future of (embeddings[B, H] np.ndarray, prompt token count)."""
        key = PACKED_KEY if self.packing else ("embed",)
        return self._submit("embed", key, list(texts))

    def consensus(self, texts, temperature: float = 0.05):
        return self.submit_consensus(texts, temperature).result()

    def embed(self, texts):
        return self.submit_embed(texts).result()

    def _submit(self, kind, key, payload) -> Future:
        item = _Item(kind, key, payload)
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.append(item)
            self._cond.notify()
        return item.future

    def stats(self) -> dict:
        """Dispatch and request counts, and the reference's packing
        efficiency counters: real tokens embedded against the token slots
        dispatched, per path."""
        with self._cond:
            pack_real, pack_slot = self._pack_real_tokens, self._pack_slot_tokens
            pad_real, pad_slot = self._pad_real_tokens, self._pad_slot_tokens
            return {
                "dispatches": dict(self._dispatches),
                "requests": dict(self._requests),
                "largest_group": self._largest_group,
                "queued": len(self._queue),
                "packing": {
                    "enabled": self.packing,
                    "dispatches": self._packed_dispatches,
                    "real_tokens": pack_real,
                    "slot_tokens": pack_slot,
                    "padding_waste": round(1.0 - pack_real / pack_slot, 4)
                    if pack_slot else 0.0,
                    "prefix_dedup_hits": self._dedup_hits,
                    "prefix_dedup_tokens_saved": self._dedup_tokens_saved,
                    "fallback_items": self._fallback_items,
                    # packed call rows B -> calls at that B
                    "bucket_occupancy": {
                        str(b): c for b, c in sorted(self._occupancy.items())
                    },
                    "call_shapes": dict(self._call_shapes),
                },
                "padded": {
                    "real_tokens": pad_real,
                    "slot_tokens": pad_slot,
                    "padding_waste": round(1.0 - pad_real / pad_slot, 4)
                    if pad_slot else 0.0,
                },
            }

    def close(self, timeout: float = 10.0) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._worker.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker side ---------------------------------------------------------

    def _candidates(self, key) -> tuple:
        """(the queued items with ``key`` that fit one group, in arrival
        order; whether the group is full).  Caller holds ``_cond``."""
        same = [it for it in self._queue if it.key == key]
        if key != PACKED_KEY:
            return same[: self.max_batch], len(same) >= self.max_batch
        budget = self.packing_max_rows * self.packing_max_segments
        take, segments = [], 0
        for item in same:
            n = max(1, len(item.texts))
            if take and segments + n > budget:
                return take, True  # later items must not jump this one
            take.append(item)
            segments += n
        return take, segments >= budget

    def _next_group(self) -> Optional[list]:
        """Block until a group is ready: the oldest item's key and the
        queued items with that key that fit one group."""
        with self._cond:
            while True:
                if not self._queue:
                    if self._closed:
                        return None
                    self._cond.wait()
                    continue
                key = self._queue[0].key
                group, full = self._candidates(key)
                waited = time.perf_counter() - self._queue[0].t_enq
                if full or waited >= self.max_wait_s or self._closed:
                    taken = set(map(id, group))
                    self._queue = deque(
                        it for it in self._queue if id(it) not in taken
                    )
                    if key == PACKED_KEY:
                        self._packed_dispatches += 1
                    else:
                        self._dispatches[key[0]] += 1
                    for item in group:
                        self._requests[item.kind] += 1
                    self._largest_group = max(self._largest_group, len(group))
                    return group
                self._cond.wait(self.max_wait_s - waited)

    def _run(self) -> None:
        while True:
            group = self._next_group()
            if group is None:
                return
            try:
                if group[0].key == PACKED_KEY:
                    results = self._dispatch_packed(group)
                elif group[0].kind == "consensus":
                    results = self._dispatch_consensus(group)
                else:
                    results = self._dispatch_embed(group)
            except Exception as exc:  # the worker must outlive a bad group
                log.exception("device dispatch failed")
                for item in group:
                    item.future.set_exception(exc)
                continue
            for item, result in zip(group, results):
                item.future.set_result(result)

    def _count(self, **deltas) -> None:
        with self._cond:
            for name, delta in deltas.items():
                setattr(self, name, getattr(self, name) + int(delta))

    def _dispatch_consensus(self, group: list) -> list:
        emb = self.embedder
        texts0, temperature = group[0].payload
        n = len(texts0)
        texts = [t for item in group for t in item.payload[0]]
        ids, mask = emb.tokenize(texts)
        r, s = len(group), ids.shape[1]
        # the dispatch pads the request axis to its power-of-two bucket
        self._count(_pad_real_tokens=mask.sum(),
                    _pad_slot_tokens=next_pow2(r) * n * s)
        conf = emb.consensus_confidence_tokens_many(
            ids.reshape(r, n, s), mask.reshape(r, n, s), temperature
        )
        tokens = mask.reshape(r, n * s).sum(axis=1)
        return [(np.asarray(conf[i]), int(tokens[i])) for i in range(r)]

    def _dispatch_embed(self, group: list) -> list:
        emb = self.embedder
        texts = [t for item in group for t in item.payload]
        ids, mask = emb.tokenize(texts)
        self._count(
            _pad_real_tokens=mask.sum(),
            _pad_slot_tokens=_bucket(ids.shape[0], emb.MAX_DEVICE_BATCH)
            * ids.shape[1],
        )
        vecs = emb.embed_tokens(ids, mask)
        row_tokens = mask.sum(axis=1)
        out, start = [], 0
        for item in group:
            stop = start + len(item.payload)
            out.append((vecs[start:stop], int(row_tokens[start:stop].sum())))
            start = stop
        return out

    # -- packed (continuous-batching) dispatch --------------------------------

    def _dispatch_packed(self, group: list) -> list:
        """One mixed group (embedding and consensus requests, any N, any
        temperature) -> per-request results through the ragged layout:
        plan every request's segments, pack the group's segments into
        ("packed", B, L, K) calls (``packing.build_calls``), one
        ``embed_packed`` per call, then assemble each request.  A request
        whose pieces do not fit a packed row takes its padded dispatch."""
        segments: list = []  # the group's ragged int32 token rows
        plans = []
        for item in group:
            plan, rows, hits, saved = self._plan_packed(item)
            if plan[0] == "fallback":
                plans.append(plan)
                continue
            plans.append(self._rebase(plan, len(segments)))
            segments.extend(rows)
            self._count(_dedup_hits=hits, _dedup_tokens_saved=saved)
        seg_vecs: list = [None] * len(segments)
        if segments:
            calls = _packing.build_calls(
                segments, self.packing_row_tokens, self.packing_max_rows,
                self.packing_max_segments,
            )
            for call in calls:
                out = self.embedder.embed_packed(
                    call.ids, call.segment_ids, call.positions,
                    call.seg_starts,
                )
                for si, (r, slot) in call.slots.items():
                    seg_vecs[si] = out[r, slot]
                b, l = call.ids.shape
                with self._cond:
                    self._pack_real_tokens += call.real_tokens
                    self._pack_slot_tokens += call.slot_tokens
                    self._occupancy[b] = self._occupancy.get(b, 0) + 1
                    shape = f"{b}x{l}"
                    self._call_shapes[shape] = self._call_shapes.get(shape, 0) + 1
        results = []
        for item, plan in zip(group, plans):
            if plan[0] == "fallback":
                self._count(_fallback_items=1)
                results.append(self._packed_item_fallback(item))
            else:
                results.append(self._assemble(plan, segments, seg_vecs))
        return results

    def _plan_packed(self, item) -> tuple:
        """One request's plan over its own segments (indices from 0),
        its ragged token rows, and its prefix-dedup hits and tokens
        saved.  Each segment is capped at ``min(row_tokens, max_tokens)``
        tokens; a plan of ("fallback",) sends the request to its padded
        dispatch (the reference's ``_plan_packed_payload``)."""
        emb = self.embedder
        row_tokens = self.packing_row_tokens
        seg_cap = min(row_tokens, emb.max_tokens)

        def fits(rows):
            return all(0 < len(r) <= row_tokens for r in rows)

        if item.kind == "embed":
            rows = emb.tokenize_ragged(item.payload, seg_cap)
            if not fits(rows):
                return ("fallback",), [], 0, 0
            return ("embed", list(range(len(rows)))), rows, 0, 0
        texts, temperature = item.payload
        prefix = (
            _packing.shared_prefix(texts, self.prefix_dedup_min_chars)
            if self.prefix_dedup else None
        )
        if prefix is not None:
            parts = [prefix] + [t[len(prefix):] for t in texts]
            # an empty suffix (candidate == prefix) embeds nothing: its
            # candidate vector is the prefix vector
            rows = emb.tokenize_ragged(
                [parts[0]] + [p for p in parts[1:] if p], seg_cap
            )
            # a prefix this short is all [CLS]/[SEP]: vote on full texts
            if len(rows[0]) >= 4 and fits(rows):
                nxt = iter(range(1, len(rows)))
                suffixes = [next(nxt) if p else None for p in parts[1:]]
                n = len(texts)
                return (
                    ("consensus_dedup", 0, suffixes, temperature), rows,
                    n - 1, (n - 1) * len(rows[0]),
                )
        rows = emb.tokenize_ragged(texts, seg_cap)
        if not fits(rows):
            return ("fallback",), [], 0, 0
        return ("consensus", list(range(len(rows))), temperature), rows, 0, 0

    @staticmethod
    def _rebase(plan, base: int):
        """Shift a plan's segment indices by ``base``, where its rows
        landed among the group's segments."""
        if plan[0] == "embed":
            return ("embed", [base + i for i in plan[1]])
        if plan[0] == "consensus":
            return ("consensus", [base + i for i in plan[1]], plan[2])
        _, prefix, suffixes, temperature = plan
        return (
            "consensus_dedup", base + prefix,
            [None if i is None else base + i for i in suffixes], temperature,
        )

    def _assemble(self, plan, segments: list, seg_vecs: list) -> tuple:
        if plan[0] == "embed":
            # an empty request gets [0, H], as from the padded path
            idxs = plan[1]
            vecs = np.zeros(
                (len(idxs), self.embedder.config.hidden_size), np.float32
            )
            for row, i in enumerate(idxs):
                vecs[row] = seg_vecs[i]
            return vecs, int(sum(len(segments[i]) for i in idxs))
        if plan[0] == "consensus_dedup":
            _, prefix, suffixes, temperature = plan
            p_tok = len(segments[prefix])
            cand = np.stack([
                _packing.compose_prefix_suffix(
                    seg_vecs[prefix], p_tok,
                    None if i is None else seg_vecs[i],
                    0 if i is None else len(segments[i]),
                )
                for i in suffixes
            ])
            tokens = p_tok + sum(
                len(segments[i]) for i in suffixes if i is not None
            )
            return _packing.consensus_vote_np(cand, temperature), int(tokens)
        _, idxs, temperature = plan
        cand = np.stack([seg_vecs[i] for i in idxs])
        return (
            _packing.consensus_vote_np(cand, temperature),
            int(sum(len(segments[i]) for i in idxs)),
        )

    def _packed_item_fallback(self, item) -> tuple:
        """One packed-key request through its padded dispatch."""
        if item.kind == "embed":
            return self._dispatch_embed([item])[0]
        return self._dispatch_consensus([item])[0]
