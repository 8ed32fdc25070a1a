"""Host <-> device embedding pipeline behind ``/consensus`` and
``/embeddings``.

Counterpart of ``llm_weighted_consensus_tpu/models/embedder.py``'s
``TpuEmbedder``, with the surface the server calls: texts are tokenized
on the host, padded to the reference's bucketed shapes, embedded by the
BERT forward and, for consensus, voted on by the cosine-vote kernel in
the same call (no host round trip between embedding and vote).

Dispatch semantics kept from the reference:

* the batch pads to ``_bucket`` rows (embed) and the sequence to
  ``_seq_bucket`` tokens, with the same ladders;
* the coalesced consensus dispatch buckets R requests to the next power
  of two; pad rows attend to one token (``mask[:, 0] = 1``) and are
  sliced off before the vote;
* the temperature is a run-time float.

One vote kernel serves the single-request and the coalesced dispatch at
every temperature; the reference splits them (fused Pallas vote only at
T=0.05 for one request, the jnp vote otherwise).

The streaming consensus (``stream_vote_update``, ``_many``, ``_tokens``)
embeds each stream's newly finished candidate at the embed bucket and
votes over the stream's device-resident buffer with a per-stream count.

The packed path (``tokenize_ragged``, ``embed_packed``) takes the ragged
layout of ``serve/packing.py``: one upload and one forward per packed
call, one pooled vector per segment.

Mesh mode (``parallel.sharding.shard_embedder_mesh``, ``MESH_ENABLED``;
``attach_mesh``) is the reference's ``_mesh_embed_and_vote`` path: the
forward runs over the mesh (``bert.embed_mesh``: batch rows over dp,
each dp row's layers tensor-parallel over tp), every dispatch pads its
rows to a dp multiple (``batch_multiple``; pad rows attend to one token
and are masked out of the vote), and the consensus dispatches vote with
``parallel.collectives.sharded_cosine_vote``, so the vote kernel
launches only for the streams there.  Graph keys are namespaced per mesh
shape, ``("mesh", dp, tp) + key`` (the ring's ``("mesh", dp, tp, sp) +
key``), and device-timing labels end in ``@dp{dp}xtp{tp}[xsp{sp}]``.  A
mesh whose shards share one card captures one CUDA graph per bucket
holding every shard; a mesh across cards runs eager (a graph captures
one device's stream), with the keys still recorded.  On a mesh with an
sp axis the dense dispatches are unchanged and the ring dispatches
(``tokenize_ring``, ``embed_tokens_ring``,
``consensus_confidence_tokens_ring``) serve sequences up to
``ring_max_tokens`` with ``parallel/ring.py``.  The legacy hooks
(``shard_embedder``: ``MESH_DP``/``MESH_TP``; ``shard_embedder_sp``:
``MESH_SP``, an ``embed_override``) keep no graphs and no packing, as in
the reference.

``warmup`` is the counterpart of the reference's ``aot_warmup``: it
captures one CUDA graph per serving bucket under the reference's keys
(``models/graphs.py``), and every dispatch at a warmed bucket replays
it; ``graph_stats`` is the counterpart of ``jit_stats``.  Every dispatch
stages its rows in pinned host buffers (``staging_pool``), and under the
batcher's deferred-readiness sink (``models/dispatch_seam.py``) returns
a ``graphs.Dispatch`` handle at enqueue, materialized by the batcher's
waiter thread; a direct call waits for its own result.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

import numpy as np
import torch

from ..ops.kernels import cosine_vote
from ..types.chat_response import Usage
from ..types.embeddings import CreateEmbeddingResponse, Embedding
from ..utils import next_pow2
from . import bert
from .dispatch_seam import StagingPool, deferred_readiness
from .graphs import GraphTable, warm_rows
from .configs import PRESETS, BertConfig, usable_positions
from .quant import resolve_quantize
from .tokenizer import BaseTokenizer, load_tokenizer

DEFAULT_VOTE_TEMPERATURE = 0.05


def _bucket(n: int, cap: int) -> int:
    """Next power of two >= n (min 16), capped."""
    size = 16
    while size < n:
        size *= 2
    return min(size, cap)


# the reference's sequence ladder: multiples of 16 to 128, then sparse
_SEQ_BUCKETS = (
    16, 32, 48, 64, 80, 96, 112, 128, 192, 256, 384, 512,
    1024, 2048, 4096, 8192,
)


def _seq_bucket(n: int, cap: int) -> int:
    for size in _SEQ_BUCKETS:
        if size >= n:
            return min(size, cap)
    return min(n, cap)


class TorchEmbedder:
    """A BGE-class encoder ready to embed and vote on ``device``.

    ``model=None`` random-inits from ``seed``; pass a ``bert.BertEncoder``
    (``loading.load_params``, ``bert.from_hf_state_dict``) for real
    weights.  Runs on CUDA unless ``device="cpu"``; the dtype defaults to
    bf16 on CUDA and f32 on the CPU.  ``quantize`` (``configs.QUANT_MODES``,
    ``EMBEDDER_QUANTIZE``) quantizes the layer stack's dense layers once,
    after the model is placed and cast, from its weights in the serving
    dtype (``models.quant.resolve_quantize``).  ``staging_buffers``
    (``STAGING_BUFFERS``) caps the pinned staging buffers kept per bucket.
    """

    MAX_DEVICE_BATCH = 4096

    def __init__(
        self,
        model_name: str = "bge-small-en",
        *,
        model: Optional[bert.BertEncoder] = None,
        config: Optional[BertConfig] = None,
        tokenizer: Optional[BaseTokenizer] = None,
        dtype: Optional[torch.dtype] = None,
        max_tokens: int = 512,
        pooling: Optional[str] = None,
        seed: int = 0,
        device=None,
        quantize: str = "none",
        staging_buffers: int = 2,
    ) -> None:
        self.model_name = model_name
        self.device = bert.resolve_device(device)
        self.dtype = dtype or bert.default_dtype(self.device)
        self.config = config or (
            model.config if model is not None else PRESETS[model_name]
        )
        self.max_tokens = min(max_tokens, usable_positions(self.config))
        self.pooling = pooling if pooling is not None else self.config.pooling
        self.tokenizer = tokenizer or load_tokenizer(
            vocab_size=self.config.vocab_size
        )
        if model is None:
            model = bert.init_params(
                self.config, seed=seed, dtype=self.dtype, device=self.device
            )
        # a quantized layer stack keeps its f32 scales through this cast
        # (quant.QuantLinear._apply); full-precision weights quantize after
        # it, from the serving dtype, as the reference does
        self.model = model.to(device=self.device, dtype=self.dtype)
        self.config = resolve_quantize(self.model, self.config, quantize)
        # CUDA graphs per warmed bucket (``warmup``); launches of every
        # dispatch, eager or replayed, under the device's launch lock
        self.graphs = GraphTable(self.device)
        # pinned host staging buffers per bucket; the batcher's waiter
        # hands them back at readiness
        self.staging_pool = StagingPool(
            per_bucket=staging_buffers, pin=self.device.type == "cuda"
        )
        # per-bucket device timing (METRICS_DEVICE_TIMING=0 clears it)
        self.device_timing = True
        # appended to every device-timing label: the reference's mesh
        # suffix (``@dp1xtp1`` under MESH_ENABLED), or the CPU twin's
        # ``@cpu``, so its rows never mix with the card's
        self.label_suffix = ""
        # the mesh (``attach_mesh``): batches pad to a dp multiple; mesh
        # mode is the first-class MESH_ENABLED path, else the legacy
        # hooks; ``embed_override`` is the legacy MESH_SP ring forward
        self.mesh = None
        self.mesh_model = None
        self.mesh_mode = False
        self.mesh_shape = None
        self.mesh_sp = 1
        self.batch_multiple = 1
        self.ring_max_tokens = None
        self.embed_override = None
        self.sp_mesh = None

    # -- the mesh --------------------------------------------------------------

    def attach_mesh(self, placed, mesh_mode: bool) -> None:
        """Serve from ``placed`` (a ``parallel.sharding.MeshModel`` of this
        embedder's model) over its mesh, whose first device must be the
        embedder's; ``mesh_mode`` is the first-class mesh (module doc),
        else the legacy hooks."""
        from ..parallel.mesh import same_device
        from .configs import usable_positions

        mesh = placed.mesh
        if not same_device(mesh.device(), self.device):
            raise ValueError(
                f"the mesh's first device {mesh.device()} is not the "
                f"embedder's {self.device}"
            )
        dp, tp = mesh.shape["dp"], mesh.shape.get("tp", 1)
        sp = mesh.shape.get("sp", 1)
        self.mesh, self.mesh_model, self.mesh_mode = mesh, placed, mesh_mode
        self.mesh_shape, self.mesh_sp = (dp, tp), sp
        self.batch_multiple = dp
        # one graph captures one device's stream: across cards, eager
        self.graphs.capture = mesh.on_one_device()
        if mesh_mode:
            self.label_suffix = f"@dp{dp}xtp{tp}" + (
                f"xsp{sp}" if sp > 1 else "")
            if sp > 1:
                # ring sequences pad to an sp multiple; the cap keeps the
                # padding inside the position table
                self.ring_max_tokens = (
                    usable_positions(self.config) // sp) * sp

    def mesh_stats(self) -> dict:
        """The ``mesh`` section of ``/metrics``: the shape traffic shards
        over, its device count, the cards it spans, the ring and the
        warmed buckets of the mesh (an embedder without a mesh is the
        1x1 shape)."""
        dp, tp = self.mesh_shape or (1, 1)
        sp = self.mesh_sp
        labels = self.graphs.stats()["keys"]
        return {
            "enabled": True, "dp": dp, "tp": tp, "sp": sp,
            "devices": dp * tp * sp,
            "cards": (len(self.mesh.distinct_devices()) if self.mesh
                      is not None else 1),
            "ring": self.ring_available(),
            "ring_max_tokens": self.ring_max_tokens,
            "aot_buckets": sum(
                1 for label in labels
                if not self.mesh_mode or label.startswith("mesh(")),
        }

    def aot_mesh_shapes(self) -> list:
        """The (dp, tp) shapes with warmed mesh-mode buckets, largest
        first: the fault ladder's audit (``analysis/mesh_audit.py``
        JXA012) reads it to show every rung was warmed."""
        shapes = {(key[1], key[2]) for key in self.graphs.keys()
                  if key and key[0] == "mesh"}
        return sorted(shapes, reverse=True)

    def has_bucket(self, key: tuple) -> bool:
        """Whether the bucket ``key`` (unnamespaced, as ``warmup`` takes
        it) is warmed on the current mesh shape."""
        return self._key(key) in self.graphs.keys()

    def has_ring_bucket(self, key: tuple) -> bool:
        return self._ring_key(key) in self.graphs.keys()

    def _key(self, key: tuple) -> tuple:
        """A graph key, namespaced per mesh shape in mesh mode."""
        if self.mesh_mode:
            return ("mesh",) + tuple(self.mesh_shape) + key
        return key

    def _ring_key(self, key: tuple) -> tuple:
        return ("mesh",) + tuple(self.mesh_shape) + (self.mesh_sp,) + key

    def _pad_to(self, rows: int) -> int:
        return rows + (-rows) % self.batch_multiple

    # -- CUDA graphs per bucket (the reference's aot_warmup) -----------------

    def _forward(self, ids, mask):
        if self.mesh_model is not None:
            return bert.embed_mesh(self.mesh_model, ids, mask,
                                   pooling=self.pooling, normalize=True)
        return bert.embed(
            self.model, ids, mask, pooling=self.pooling, normalize=True
        )

    def _forward_packed(self, ids, segment_ids, positions, seg_starts):
        # embed_packed bounded the positions on its host copy
        if self.mesh_model is not None:
            return bert.embed_packed_mesh(
                self.mesh_model, ids, segment_ids, positions, seg_starts,
                pooling=self.pooling, normalize=True, positions_checked=True,
            )
        return bert.embed_packed(
            self.model, ids, segment_ids, positions, seg_starts,
            pooling=self.pooling, normalize=True, positions_checked=True,
        )

    def _forward_ring(self, ids, mask):
        from ..parallel.ring import ring_embed

        return ring_embed(self.mesh_model, ids, mask, self.mesh,
                          dp_axis="dp", pooling=self.pooling)

    def _vote(self, emb, n: int, temperature: float, r: int = 0):
        """The consensus vote after a forward: the cosine-vote kernel on
        one device (``r`` > 0: ``emb[:r * n]`` as r requests), the
        dp-sharded vote in mesh mode (per request)."""
        if self.mesh is None:
            if r:
                return cosine_vote(emb[: r * n].reshape(r, n, -1), n,
                                   temperature)
            return cosine_vote(emb[:n].reshape(1, n, -1), n,
                               temperature)[0]
        from ..parallel.collectives import sharded_cosine_vote

        if not r:
            return sharded_cosine_vote(emb, self.mesh, temperature,
                                       n_valid=n)
        return torch.stack([
            sharded_cosine_vote(emb[i * n:(i + 1) * n], self.mesh,
                                temperature)
            for i in range(r)
        ])

    def warmup(
        self, specs: list, r_buckets: list = (), packed_buckets: list = (),
        ring_buckets: list = (),
    ) -> list:
        """Capture a CUDA graph for every serving bucket up front: per
        (N, S) spec the single-request consensus forward ``("vote1", N,
        S)``, the embed forward at its padded batch ``("embed", pad_b,
        S)``, and per ``r_buckets`` entry >= 2 the grouped forward
        ``("many", R, N, S)``; per packed (B, L, K) the packed forward
        ``("packed", B, L, K)``.  S snaps to the serving sequence bucket.
        Traffic at a warmed bucket replays its graph and captures
        nothing; the vote stays outside every graph (one launch after the
        replay, its temperature a run-time value).  On the CPU the keys
        are recorded and nothing is captured.  Returns [(label, seconds)]
        for the buckets warmed by this call.

        In mesh mode the keys are the mesh's (``_key``) and the row
        counts padded to the dp multiple, as the dispatches pad them;
        ``ring_buckets`` ((N, S) specs, ``LONG_CONTEXT_WARMUP``) warm the
        ring dispatches of an sp mesh and nothing elsewhere.  The legacy
        hook embedders keep no graphs: their warmup runs one eager
        consensus dispatch per spec, as the reference's does."""
        if self.embed_override is not None or (
                self.mesh is not None and not self.mesh_mode):
            return self._warm_by_dispatch(specs)
        warm = self.graphs.warm
        pad = self._pad_to
        timings = []
        for n, s in specs:
            s = _seq_bucket(s, self.max_tokens)
            pad_b = pad(_bucket(n, self.MAX_DEVICE_BATCH))
            timings.append(warm(self._key(("vote1", n, s)),
                                warm_rows(pad(n), s), self._forward))
            timings.append(warm(self._key(("embed", pad_b, s)),
                                warm_rows(pad_b, s), self._forward))
            timings += [
                warm(self._key(("many", r, n, s)), warm_rows(pad(r * n), s),
                     self._forward)
                for r in r_buckets
                if r >= 2  # R=1 groups dispatch the single-request path
            ]
        for b, l, k in packed_buckets:
            b = pad(b)
            col = np.arange(l, dtype=np.int32)
            width = min(l, self.max_tokens)
            inputs = {
                "ids": np.zeros((b, l), np.int32),
                "segment_ids": np.tile(col // width + 1, (b, 1)),
                "positions": np.tile(col % width, (b, 1)),
                "seg_starts": np.zeros((b, k), np.int32),
            }
            timings.append(warm(self._key(("packed", b, l, k)), inputs,
                                self._forward_packed))
        if ring_buckets and self.ring_available():
            sp = self.mesh_sp
            for n, s in ring_buckets:
                s = _seq_bucket(s, self.ring_max_tokens)
                s = min(s + (-s) % sp, self.ring_max_tokens)
                pad_b = pad(_bucket(n, self.MAX_DEVICE_BATCH))
                timings.append(warm(self._ring_key(("ring_vote", n, s)),
                                    warm_rows(pad(n), s),
                                    self._forward_ring))
                timings.append(warm(self._ring_key(("ring", pad_b, s)),
                                    warm_rows(pad_b, s), self._forward_ring))
        return [t for t in timings if t is not None]

    def _warm_by_dispatch(self, specs: list) -> list:
        timings = []
        for n, s in specs:
            s = _seq_bucket(s, self.max_tokens)
            t0 = time.perf_counter()
            with deferred_readiness(None):
                self.consensus_confidence_tokens(*(
                    a[:n] for a in warm_rows(n, s).values()))
            timings.append((f"dispatch vote1({n},{s})",
                            time.perf_counter() - t0))
        return timings

    def graph_stats(self) -> dict:
        """The counterpart of the reference's ``jit_stats``: ``graphs``,
        ``captures``, ``replays``, ``eager_dispatches`` and
        ``pool_bytes`` (``models.graphs.GraphTable.stats``)."""
        return self.graphs.stats()

    def _dispatch(self, key, label, arrays, forward, post):
        """One dispatch at bucket ``key`` (``GraphTable.dispatch``): a
        handle under the batcher's sink, the numpy result otherwise."""
        return self.graphs.dispatch(
            key, label + self.label_suffix, arrays, forward, post,
            self.staging_pool,
            timed=self.device_timing,
        )

    # -- core ----------------------------------------------------------------

    def tokenize(self, texts: Iterable[str], max_tokens: Optional[int] = None):
        cap = min(max_tokens or self.max_tokens, self.max_tokens)
        ids, mask = self.tokenizer.encode_batch(list(texts), cap)
        seq = _seq_bucket(int(mask.sum(axis=1).max(initial=1)), cap)
        return ids[:, :seq], mask[:, :seq]

    def embed_texts(
        self, texts: list, max_tokens: Optional[int] = None
    ) -> np.ndarray:
        """texts -> embeddings[B, H] (f32, L2-normalised)."""
        ids, mask = self.tokenize(texts, max_tokens)
        return self.embed_tokens(ids, mask)

    def embed_tokens(self, ids: np.ndarray, mask: np.ndarray):
        """ids/mask[B, S] -> embeddings[B, H] f32 (a handle under the
        batcher's sink).  Batches past ``MAX_DEVICE_BATCH`` run in chunks,
        each waited for here."""
        b = ids.shape[0]
        if b > self.MAX_DEVICE_BATCH:
            with deferred_readiness(None):
                return np.concatenate(
                    [
                        self.embed_tokens(
                            ids[i : i + self.MAX_DEVICE_BATCH],
                            mask[i : i + self.MAX_DEVICE_BATCH],
                        )
                        for i in range(0, b, self.MAX_DEVICE_BATCH)
                    ],
                    axis=0,
                )
        pad_b = self._pad_to(_bucket(b, self.MAX_DEVICE_BATCH))
        s = ids.shape[1]
        pids = np.zeros((pad_b, s), np.int32)
        pmask = np.zeros((pad_b, s), np.int32)
        pids[:b] = ids
        pmask[:b] = mask
        if self.embed_override is not None:
            return self.embed_override(pids, pmask)[:b]
        return self._dispatch(
            self._key(("embed", pad_b, s)), f"embed(b={pad_b},s={s})",
            {"ids": pids, "mask": pmask}, self._forward,
            lambda emb: emb[:b],
        )

    def consensus_confidence(
        self,
        texts: list,
        max_tokens: Optional[int] = None,
        temperature: float = DEFAULT_VOTE_TEMPERATURE,
    ) -> np.ndarray:
        """texts (N candidates) -> confidence[N]: embed and vote in one
        call."""
        ids, mask = self.tokenize(texts, max_tokens)
        return self.consensus_confidence_tokens(ids, mask, temperature)

    def consensus_confidence_tokens(
        self,
        ids: np.ndarray,
        mask: np.ndarray,
        temperature: float = DEFAULT_VOTE_TEMPERATURE,
    ):
        """ids/mask[N, S] -> confidence[N]: the forward at ``("vote1", N,
        S)`` and one vote launch after it (on a mesh: rows padded to the
        dp multiple, pad rows attending to one token, and the sharded
        vote over the first N)."""
        n, s = ids.shape
        temperature = float(temperature)
        pad_n = self._pad_to(n)
        if pad_n != n:
            ids = np.concatenate([ids, np.zeros((pad_n - n, s), np.int32)])
            mask = np.concatenate([mask, np.zeros((pad_n - n, s), np.int32)])
            mask[n:, 0] = 1
        return self._dispatch(
            self._key(("vote1", n, s)), f"vote1(n={n},s={s})",
            {"ids": ids, "mask": mask}, self._forward,
            lambda emb: self._vote(emb, n, temperature),
        )

    def consensus_confidence_tokens_many(
        self,
        ids: np.ndarray,
        mask: np.ndarray,
        temperature: float = DEFAULT_VOTE_TEMPERATURE,
    ):
        """ids/mask[R, N, S] (R coalesced requests) -> confidence[R, N] in
        one forward and one vote launch.  R pads to the next power of two;
        pad rows attend to one token and are sliced off before the
        vote."""
        r, n, s = ids.shape
        r_bucket = next_pow2(r)
        rows = self._pad_to(r_bucket * n)
        flat_ids = np.zeros((rows, s), np.int32)
        flat_mask = np.zeros((rows, s), np.int32)
        flat_ids[: r * n] = ids.reshape(r * n, s)
        flat_mask[: r * n] = mask.reshape(r * n, s)
        flat_mask[r * n :, 0] = 1
        temperature = float(temperature)
        return self._dispatch(
            self._key(("many", r_bucket, n, s)),
            f"many(r={r_bucket},n={n},s={s})",
            {"ids": flat_ids, "mask": flat_mask}, self._forward,
            lambda emb: self._vote(emb, n, temperature, r),
        )

    # -- streaming consensus ---------------------------------------------------

    def stream_buffer(self, capacity: int) -> torch.Tensor:
        """A stream's device-resident consensus state: zeros[capacity, H]
        f32 on the embedder's device (``clients.multichat``)."""
        return torch.zeros(
            (capacity, self.config.hidden_size), dtype=torch.float32,
            device=self.device,
        )

    def stream_vote_update(
        self,
        text: str,
        buf: torch.Tensor,
        position: int,
        temperature: float = DEFAULT_VOTE_TEMPERATURE,
    ) -> np.ndarray:
        """One streaming-consensus step: embed ``text``, write its vector
        into ``buf[position]`` in place and vote over ``buf``'s first
        ``position + 1`` rows -> confidence[CAP] on the host.  The
        counterpart of the reference's ``TpuEmbedder.stream_vote_update``;
        one dispatch (``stream_vote_update_many`` with one stream)."""
        return self.stream_vote_update_many(
            [text], [buf], [position], temperature
        )[0]

    def stream_vote_update_many(
        self,
        texts: list,
        bufs: list,
        positions: list,
        temperature: float = DEFAULT_VOTE_TEMPERATURE,
    ) -> np.ndarray:
        """R streaming-consensus steps (one per stream, buffers of one
        capacity) in one dispatch -> confidences[R, CAP] on the host."""
        ids, mask = self.tokenize(texts)
        return self.stream_vote_update_tokens(
            ids, mask, bufs, positions, temperature
        )

    def stream_vote_update_tokens(
        self,
        ids: np.ndarray,
        mask: np.ndarray,
        bufs: list,
        positions: list,
        temperature: float = DEFAULT_VOTE_TEMPERATURE,
        wanted: Optional[list] = None,
    ):
        """ids/mask[R, S] (one new candidate per stream) -> the
        confidences of the streams in ``wanted`` (row indexes, default
        all), [len(wanted), CAP], in one dispatch: the forward at the
        embed bucket ``("embed", pad_b, S)`` (a warmed graph replays),
        each vector written into its stream's ``bufs[i][positions[i]]``
        in place, then one ``cosine_vote`` launch over the stacked buffers
        with ``n_valid = positions + 1`` per stream (a stream's live rows
        are always a prefix), and one copy back of the wanted rows.

        A buffer row is live only below its stream's count: a dispatch
        that fails after the write leaves a row the next update of that
        stream overwrites (its position is the same count again)."""
        r = len(bufs)
        cap = int(bufs[0].shape[0])
        for buf in bufs:
            if tuple(buf.shape) != (cap, self.config.hidden_size) or (
                buf.dtype != torch.float32
                or buf.device.type != self.device.type
            ):
                raise ValueError(
                    f"stream buffers must be f32 [{cap}, "
                    f"{self.config.hidden_size}] on {self.device}"
                )
        for position in positions:
            if not 0 <= int(position) < cap:
                raise ValueError(f"position {position} outside [0, {cap})")
        wanted = list(range(r)) if wanted is None else list(wanted)
        pad_b = self._pad_to(_bucket(r, self.MAX_DEVICE_BATCH))
        s = ids.shape[1]
        pids = np.zeros((pad_b, s), np.int32)
        pmask = np.zeros((pad_b, s), np.int32)
        pids[:r] = ids
        pmask[:r] = mask
        pmask[r:, 0] = 1
        # the per-stream counts and the wanted rows, one upload (pinned on
        # the card, so the copy is asynchronous like the staged rows)
        index = torch.tensor(
            [int(p) + 1 for p in positions] + wanted, dtype=torch.int32
        )
        if self.device.type == "cuda":
            index = index.pin_memory()
        temperature = float(temperature)

        def post(emb: torch.Tensor) -> torch.Tensor:
            dev_index = index.to(self.device, non_blocking=True)
            vecs = emb[:r].float()
            for i, (buf, position) in enumerate(zip(bufs, positions)):
                buf[int(position)].copy_(vecs[i])
            conf = cosine_vote(torch.stack(bufs), dev_index[:r], temperature)
            if wanted == list(range(r)):
                return conf
            return conf.index_select(0, dev_index[r:].long())

        try:
            return self._dispatch(
                self._key(("embed", pad_b, s)),
                f"stream(r={r},cap={cap},s={s})",
                {"ids": pids, "mask": pmask}, self._forward, post,
            )
        except BaseException:
            # the pinned upload of a failed dispatch is never freed
            # (``StagingPool.retain``)
            self.staging_pool.retain(index)
            raise

    # -- packed (continuous-batching) path ------------------------------------

    def supports_packing(self) -> bool:
        """The packed dispatch: on one device and in mesh mode; the legacy
        hooks keep the padded paths, as in the reference."""
        return self.embed_override is None and (
            self.mesh is None or self.mesh_mode)

    def tokenize_ragged(
        self, texts: Iterable[str], max_tokens: Optional[int] = None
    ) -> list:
        """texts -> list of 1-D int32 token rows, padding stripped: each
        row is what ``tokenize`` gives that text before padding, so a
        packed segment embeds the same tokens as its padded twin."""
        cap = min(max_tokens or self.max_tokens, self.max_tokens)
        ids, mask = self.tokenizer.encode_batch(list(texts), cap)
        lens = mask.sum(axis=1)
        return [
            np.ascontiguousarray(ids[i, : int(lens[i])], np.int32)
            for i in range(ids.shape[0])
        ]

    def embed_packed(
        self,
        ids: np.ndarray,
        segment_ids: np.ndarray,
        positions: np.ndarray,
        seg_starts: np.ndarray,
    ):
        """Packed layout ids/segment_ids/positions[B, L] and
        seg_starts[B, K] -> per-slot embeddings[B, K, H] (f32,
        L2-normalised), one forward at ``("packed", B, L, K)``.  The
        segments are bounded by the position table here, on the host
        copy, before the upload."""
        positions = np.asarray(positions)
        if positions.size:
            last = int(positions.max())
            bert.check_positions(
                self.config, last, f"a segment of {last + 1} tokens"
            )
        b, l = np.shape(ids)
        k = np.shape(seg_starts)[1]
        arrays = {"ids": ids, "segment_ids": segment_ids,
                  "positions": positions, "seg_starts": seg_starts}
        pb = self._pad_to(b)
        if pb != b:
            # all-zero rows: segment id 0 is the fully masked pad slot
            arrays = {name: np.pad(np.asarray(a, np.int32),
                                   ((0, pb - b), (0, 0)))
                      for name, a in arrays.items()}
        return self._dispatch(
            self._key(("packed", pb, l, k)), f"packed(b={pb},l={l},k={k})",
            arrays, self._forward_packed, lambda out: out[:b],
        )

    # -- long-context ring (sequence-parallel) path ---------------------------

    def ring_available(self) -> bool:
        """Whether the ring dispatch is wired: mesh mode on a mesh with an
        sp axis.  The batcher routes over-length requests here only then;
        otherwise they truncate at ``max_tokens``."""
        return self.mesh_mode and self.mesh_sp > 1

    def _require_ring(self) -> None:
        if not self.ring_available():
            raise RuntimeError(
                "ring dispatch needs first-class mesh mode on a mesh "
                "with an sp axis (MESH_SHAPE=dp,tp,sp + "
                "shard_embedder_mesh)"
            )

    def _ring_pad_seq(self, ids, mask):
        """Pad the sequence to an sp multiple (pads are masked keys)."""
        pad_s = (-ids.shape[1]) % self.mesh_sp
        if pad_s:
            ids = np.pad(np.asarray(ids), ((0, 0), (0, pad_s)))
            mask = np.pad(np.asarray(mask), ((0, 0), (0, pad_s)))
        return ids, mask

    def tokenize_ring(self, texts: Iterable[str],
                      max_tokens: Optional[int] = None):
        """``tokenize`` for the ring: capped at ``ring_max_tokens`` (the
        position window rounded down to an sp multiple), the trimmed
        sequence bucket rounded up to an sp multiple."""
        self._require_ring()
        sp = self.mesh_sp
        cap = min(max_tokens or self.ring_max_tokens, self.ring_max_tokens)
        cap = max((cap // sp) * sp, sp)
        ids, mask = self.tokenizer.encode_batch(list(texts), cap)
        seq = _seq_bucket(int(mask.sum(axis=1).max(initial=1)), cap)
        seq = min(seq + (-seq) % sp, cap)
        return ids[:, :seq], mask[:, :seq]

    def embed_tokens_ring(self, ids: np.ndarray, mask: np.ndarray):
        """The ring twin of ``embed_tokens``: the sequence split over sp,
        attention as a ring (``parallel/ring.py``), one dispatch at
        ``("mesh", dp, tp, sp, "ring", b, s)``."""
        self._require_ring()
        b = ids.shape[0]
        ids, mask = self._ring_pad_seq(ids, mask)
        pad_b = self._pad_to(_bucket(b, self.MAX_DEVICE_BATCH))
        s = ids.shape[1]
        pids = np.zeros((pad_b, s), np.int32)
        pmask = np.zeros((pad_b, s), np.int32)
        pids[:b] = ids
        pmask[:b] = mask
        return self._dispatch(
            self._ring_key(("ring", pad_b, s)), f"ring(b={pad_b},s={s})",
            {"ids": pids, "mask": pmask}, self._forward_ring,
            lambda emb: emb[:b],
        )

    def consensus_confidence_tokens_ring(
        self, ids: np.ndarray, mask: np.ndarray,
        temperature: float = DEFAULT_VOTE_TEMPERATURE,
    ):
        """The ring twin of ``consensus_confidence_tokens``: the
        sequence-split forward and the dp-sharded vote in one dispatch,
        pad rows masked by ``n_valid``."""
        self._require_ring()
        n = ids.shape[0]
        ids, mask = self._ring_pad_seq(ids, mask)
        s = ids.shape[1]
        pad_n = self._pad_to(n)
        pids = np.zeros((pad_n, s), np.int32)
        pmask = np.zeros((pad_n, s), np.int32)
        pids[:n] = ids
        pmask[:n] = mask
        pmask[n:, 0] = 1
        temperature = float(temperature)
        return self._dispatch(
            self._ring_key(("ring_vote", n, s)), f"ring_vote(n={n},s={s})",
            {"ids": pids, "mask": pmask}, self._forward_ring,
            lambda emb: self._vote(emb, n, temperature),
        )

    # -- wire contract --------------------------------------------------------

    def wire_response(
        self, emb: np.ndarray, tokens: int
    ) -> CreateEmbeddingResponse:
        """Already-computed embeddings as the OpenAI response, with usage
        = the real token count."""
        rows = np.asarray(emb).tolist()
        return CreateEmbeddingResponse(
            object="list",
            data=[
                Embedding(object="embedding", index=i, embedding=row)
                for i, row in enumerate(rows)
            ],
            model=self.model_name,
            usage=Usage(
                prompt_tokens=tokens, completion_tokens=0, total_tokens=tokens
            ),
        )

    def embeddings_response(
        self, texts: list, max_tokens: Optional[int] = None
    ) -> CreateEmbeddingResponse:
        """The OpenAI embeddings response.  Tokenizes once."""
        ids, mask = self.tokenize(texts, max_tokens)
        emb = self.embed_tokens(ids, mask)
        return self.wire_response(emb, int(mask.sum()))
