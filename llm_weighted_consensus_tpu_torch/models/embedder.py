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

The packed path (``tokenize_ragged``, ``embed_packed``) takes the ragged
layout of ``serve/packing.py``: one upload and one forward per packed
call, one pooled vector per segment.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from ..ops.kernels import cosine_vote
from ..types.embeddings import CreateEmbeddingResponse, Embedding, Usage
from . import bert
from .configs import PRESETS, BertConfig, usable_positions
from .quant import resolve_quantize
from .tokenizer import BaseTokenizer, load_tokenizer

DEFAULT_VOTE_TEMPERATURE = 0.05


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1): the R-bucketing rule."""
    bucket = 1
    while bucket < n:
        bucket *= 2
    return bucket


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
    dtype (``models.quant.resolve_quantize``).
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

    # -- core ----------------------------------------------------------------

    def tokenize(self, texts: Iterable[str], max_tokens: Optional[int] = None):
        cap = min(max_tokens or self.max_tokens, self.max_tokens)
        ids, mask = self.tokenizer.encode_batch(list(texts), cap)
        seq = _seq_bucket(int(mask.sum(axis=1).max(initial=1)), cap)
        return ids[:, :seq], mask[:, :seq]

    def _upload(self, ids: np.ndarray, mask: np.ndarray):
        return (
            torch.from_numpy(np.ascontiguousarray(ids, np.int32)).to(
                self.device
            ),
            torch.from_numpy(np.ascontiguousarray(mask, np.int32)).to(
                self.device
            ),
        )

    def _embed_device(self, ids: np.ndarray, mask: np.ndarray):
        dev_ids, dev_mask = self._upload(ids, mask)
        return bert.embed(
            self.model, dev_ids, dev_mask, pooling=self.pooling, normalize=True
        )

    def embed_texts(
        self, texts: list, max_tokens: Optional[int] = None
    ) -> np.ndarray:
        """texts -> embeddings[B, H] (f32, L2-normalised)."""
        ids, mask = self.tokenize(texts, max_tokens)
        return self.embed_tokens(ids, mask)

    @torch.inference_mode()
    def embed_tokens(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        b = ids.shape[0]
        if b > self.MAX_DEVICE_BATCH:
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
        pad_b = _bucket(b, self.MAX_DEVICE_BATCH)
        if pad_b != b:
            ids = np.pad(np.asarray(ids), ((0, pad_b - b), (0, 0)))
            mask = np.pad(np.asarray(mask), ((0, pad_b - b), (0, 0)))
        emb = self._embed_device(ids, mask)
        return emb[:b].cpu().numpy()

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

    @torch.inference_mode()
    def consensus_confidence_tokens(
        self,
        ids: np.ndarray,
        mask: np.ndarray,
        temperature: float = DEFAULT_VOTE_TEMPERATURE,
    ) -> np.ndarray:
        n = ids.shape[0]
        emb = self._embed_device(ids, mask)
        conf = cosine_vote(emb[:n].reshape(1, n, -1), n, float(temperature))
        return conf[0].cpu().numpy()

    @torch.inference_mode()
    def consensus_confidence_tokens_many(
        self,
        ids: np.ndarray,
        mask: np.ndarray,
        temperature: float = DEFAULT_VOTE_TEMPERATURE,
    ) -> np.ndarray:
        """ids/mask[R, N, S] (R coalesced requests) -> confidence[R, N] in
        one forward and one vote launch.  R pads to the next power of two;
        pad rows attend to one token and are sliced off before the
        vote."""
        r, n, s = ids.shape
        r_bucket = next_pow2(r)
        flat_ids = np.zeros((r_bucket * n, s), np.int32)
        flat_mask = np.zeros((r_bucket * n, s), np.int32)
        flat_ids[: r * n] = ids.reshape(r * n, s)
        flat_mask[: r * n] = mask.reshape(r * n, s)
        flat_mask[r * n :, 0] = 1
        emb = self._embed_device(flat_ids, flat_mask)
        conf = cosine_vote(
            emb[: r * n].reshape(r, n, -1), n, float(temperature)
        )
        return conf.cpu().numpy()

    # -- packed (continuous-batching) path ------------------------------------

    def supports_packing(self) -> bool:
        """The packed dispatch is always available in the port (one
        device, no mesh hooks)."""
        return True

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

    @torch.inference_mode()
    def embed_packed(
        self,
        ids: np.ndarray,
        segment_ids: np.ndarray,
        positions: np.ndarray,
        seg_starts: np.ndarray,
    ) -> np.ndarray:
        """Packed layout ids/segment_ids/positions[B, L] and
        seg_starts[B, K] -> per-slot embeddings[B, K, H] (f32,
        L2-normalised).  The segments are bounded by the position table
        here, on the host copy, before one int32 upload and one forward."""
        positions = np.asarray(positions)
        if positions.size:
            last = int(positions.max())
            bert.check_positions(
                self.config, last, f"a segment of {last + 1} tokens"
            )
        parts = [np.ascontiguousarray(a, np.int32).ravel()
                 for a in (ids, segment_ids, positions, seg_starts)]
        flat = torch.from_numpy(np.concatenate(parts)).to(self.device)
        b, l = np.shape(ids)
        dev_ids, dev_seg, dev_pos, dev_starts = (
            t.view(shape) for t, shape in zip(
                torch.split(flat, [p.size for p in parts]),
                ((b, l), (b, l), (b, l), np.shape(seg_starts)),
            )
        )
        out = bert.embed_packed(
            self.model, dev_ids, dev_seg, dev_pos, dev_starts,
            pooling=self.pooling, normalize=True,
        )
        return out.cpu().numpy()

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
