"""The trained-weights path on the card: prompt embedding -> per-judge
weights.

Counterpart of ``llm_weighted_consensus_tpu/weights/training_table.py``
(``TrainingTableStore``, ``TpuTrainingTableFetcher``).  The panel's
``weight`` config is ``{"type": "training_table", "embeddings":
{"model", "max_tokens", ...}, "top": k}``; a request's weights come from:

1. the conversation flattened by ``template_content`` (the reference's
   designated embedding input);
2. its embedding at the panel's ``embeddings.max_tokens``, through the
   serving batcher when there is one (the prompt embed coalesces with
   other requests' device work and replays the warmed CUDA graph of its
   bucket), else through the embedder off the event loop;
3. one padded lookup over every judge that has a table
   (``ops.similarity.training_table_weights_batched``: cosine top-k per
   judge, attention-weighted mean of the top rows' scores, interpolated
   into the judge's [min_weight, max_weight]), on the embedder's device;
4. judges without table data keep their ``base_weight``;
5. the embeddings response is echoed as ``weight_data``, and its usage
   seeds the score response's usage.

Each weight is ``Decimal(repr(float(v)))`` of the f32 result, as in the
reference: a one-ulp difference changes the frame's bytes, so the lookup
runs in f32.  On CUDA the fetcher embeds and looks up on the card or
raises; it never falls back to the CPU.
"""

from __future__ import annotations

import asyncio
from decimal import Decimal
from typing import Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..types.score_response import TrainingTableData
from . import TrainingTableWeightFetcher


class TrainingTableStore:
    """In-memory training tables keyed by judge ``training_table_id``.

    A row is (prompt embedding, outcome score in [0, 1]); rows are
    appended as scored conversations are archived.  ``save``/``load``
    use the reference's ``.npz`` layout, so either package reads the
    other's snapshot.
    """

    def __init__(self) -> None:
        self._tables: dict = {}
        # completion ids already learned from: the idempotence guard of
        # repeated learning passes over one archive
        self._ingested: set = set()

    def is_ingested(self, completion_id: str) -> bool:
        return completion_id in self._ingested

    def mark_ingested(self, completion_id: str) -> None:
        self._ingested.add(completion_id)

    def add_rows(
        self, table_id: str, embeddings: np.ndarray, scores: np.ndarray
    ) -> None:
        embeddings = np.asarray(embeddings, dtype=np.float32)
        scores = np.asarray(scores, dtype=np.float32)
        if table_id in self._tables:
            old_e, old_s = self._tables[table_id]
            embeddings = np.concatenate([old_e, embeddings])
            scores = np.concatenate([old_s, scores])
        self._tables[table_id] = (embeddings, scores)

    def get(self, table_id: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        return self._tables.get(table_id)

    def __len__(self) -> int:
        return len(self._tables)

    def save(self, path: str) -> None:
        """One .npz holding every table + the ingested-id set (atomic)."""
        from ..utils.io import atomic_write

        arrays = {}
        for table_id, (emb, scores) in self._tables.items():
            arrays[f"e:{table_id}"] = emb
            arrays[f"s:{table_id}"] = scores
        arrays["ingested"] = np.asarray(sorted(self._ingested), dtype="U")
        atomic_write(path, lambda f: np.savez(f, **arrays))

    @classmethod
    def load(cls, path: str) -> "TrainingTableStore":
        store = cls()
        with np.load(path) as data:
            for key in data.files:
                if key.startswith("e:"):
                    table_id = key[2:]
                    store._tables[table_id] = (
                        data[key], data[f"s:{table_id}"]
                    )
            if "ingested" in data.files:
                store._ingested = set(data["ingested"].tolist())
        return store


class PaddedTables:
    """The host side of one lookup: every judge with a table, its rows
    padded to the panel's longest table.  ``weights`` holds the
    ``base_weight`` of judges without a table and None where the lookup
    fills in; ``positions`` are those judges' places in it."""

    __slots__ = ("weights", "positions", "tables", "row_mask", "scores",
                 "lo", "hi", "k")

    def __init__(self, weights, positions, tables=None, row_mask=None,
                 scores=None, lo=None, hi=None, k=0) -> None:
        self.weights = weights
        self.positions = positions
        self.tables = tables
        self.row_mask = row_mask
        self.scores = scores
        self.lo = lo
        self.hi = hi
        self.k = k


class TorchTrainingTableFetcher(TrainingTableWeightFetcher):
    """The training-table fetcher on the served embedder (and its
    batcher, when the server has one)."""

    def __init__(
        self,
        embedder,
        store: Optional[TrainingTableStore] = None,
        batcher=None,
    ):
        self.embedder = embedder
        # NOT `store or ...`: an EMPTY shared store is falsy (__len__ == 0)
        # and would be silently replaced, detaching the fetcher from the
        # store that learning later populates
        self.store = store if store is not None else TrainingTableStore()
        self.batcher = batcher

    async def fetch(self, ctx, request, model):
        """(weights, TrainingTableData).  Runs on the chat routes' event
        loop, where every judge stream of every request also runs: the
        prompt embed is awaited as the batcher's future, and the embed
        without a batcher and the lookup run in the loop's executor, so
        no device wait blocks the loop.  A traced request's span goes
        along into the executor (``obs.carry``); the batcher's item
        carries its own."""
        loop = asyncio.get_running_loop()
        max_tokens = getattr(model.weight.embeddings, "max_tokens", None)
        text = request.template_content()
        if self.batcher is None:
            response = await loop.run_in_executor(
                None, obs.carry(self.embedder.embeddings_response), [text],
                max_tokens,
            )
        else:
            emb, tokens = await self.batcher.wait_async(
                self.batcher.submit_embed([text], max_tokens=max_tokens)
            )
            response = self.embedder.wire_response(emb, tokens)
        return await loop.run_in_executor(
            None, obs.carry(self._lookup), response, model)

    def _lookup(self, response, model):
        query = np.asarray(response.data[0].embedding, dtype=np.float32)
        padded = self.pad_tables(model)
        if padded.positions:
            out = self.lookup(padded, query)
            for pos, value in zip(padded.positions, out):
                padded.weights[pos] = Decimal(repr(float(value)))
        return padded.weights, TrainingTableData(embeddings_response=response)

    def pad_tables(self, model) -> PaddedTables:
        """Collect the judges that have a table and pad their rows to the
        longest one (the lookup's host part)."""
        with_table = []  # (table_emb, table_scores, min_w, max_w)
        weights: list = []
        positions: list = []
        for llm in model.llms:
            w = llm.base.weight  # WeightTrainingTable
            table = (
                self.store.get(llm.training_table_id)
                if llm.training_table_id
                else None
            )
            if table is None:
                weights.append(w.base_weight)
                continue
            positions.append(len(weights))
            weights.append(None)  # filled from the batched lookup
            with_table.append(
                (*table, float(w.min_weight), float(w.max_weight))
            )
        if not with_table:
            return PaddedTables(weights, positions)
        t_max = max(emb.shape[0] for emb, _, _, _ in with_table)
        j = len(with_table)
        d = with_table[0][0].shape[1]
        tables = np.zeros((j, t_max, d), dtype=np.float32)
        row_mask = np.zeros((j, t_max), dtype=np.float32)
        scores = np.zeros((j, t_max), dtype=np.float32)
        lo = np.zeros((j,), dtype=np.float32)
        hi = np.zeros((j,), dtype=np.float32)
        for idx, (emb, sc, mn, mx) in enumerate(with_table):
            rows = emb.shape[0]
            tables[idx, :rows] = emb
            row_mask[idx, :rows] = 1.0
            scores[idx, :rows] = sc
            lo[idx], hi[idx] = mn, mx
        return PaddedTables(weights, positions, tables, row_mask, scores,
                            lo, hi, min(int(model.weight.top), t_max))

    def upload(self, padded: PaddedTables, query: np.ndarray) -> tuple:
        """The lookup's inputs on the embedder's device."""
        device = self.embedder.device
        return tuple(
            torch.from_numpy(a).to(device)
            for a in (padded.tables, padded.row_mask, padded.scores, query,
                      padded.lo, padded.hi)
        )

    def lookup(self, padded: PaddedTables, query: np.ndarray) -> np.ndarray:
        """weights[J] f32 of the judges in ``padded``: one upload, one
        lookup on the embedder's device and one copy back."""
        from ..ops.similarity import training_table_weights_batched

        args = self.upload(padded, query)
        out = training_table_weights_batched(*args, padded.k)
        return out.cpu().numpy()
