"""Served reward-model re-ranking: ``/consensus {"scorer": "rm"}``.

Counterpart of ``llm_weighted_consensus_tpu/models/reranker.py``'s
``TpuReranker``: candidates are tokenized on the host (SentencePiece
unigram for real checkpoints, the hash tokenizer for shape work), the
DeBERTa reward model scores each (prompt, candidate) pair on the device,
and ``softmax(reward / T)`` over the request's candidates is the
confidence, in the same forward.

There is no micro-batching: the softmax normalizes over exactly one
request's candidates, so each request runs on its own, on the server's
handler thread.  One forward issues its launches at a time: eager
launches from concurrent threads contend for the interpreter lock at
every op, which cost more than half the served throughput on an H100
(``PERF.md``).  Under a quantize mode the six content and MLP dense
layers of every layer run the W8A8 / W4A8 kernels (``models.quant``).
"""

from __future__ import annotations

import threading
from typing import Iterable, Optional

import numpy as np
import torch

from . import deberta
from .bert import default_dtype, resolve_device
from .configs import DEBERTA_TEST_TINY, DEBERTA_V3_BASE, DebertaConfig
from .embedder import _seq_bucket
from .quant import resolve_quantize
from .tokenizer import BaseTokenizer, load_tokenizer

RM_PRESETS = {
    "deberta-v3-base": DEBERTA_V3_BASE,
    "deberta-test-tiny": DEBERTA_TEST_TINY,
}
DEFAULT_RM_TEMPERATURE = 1.0


class TorchReranker:
    """A DeBERTa reward model ready to re-rank candidate sets on
    ``device``.

    ``model=None`` random-inits from ``seed``; pass a
    ``deberta.DebertaModel`` (``loading.load_rm_params``,
    ``deberta.from_hf_weights``, ``deberta.from_state``) for real
    weights.  Runs on CUDA unless ``device="cpu"``; the dtype defaults to
    bf16 on CUDA and f32 on the CPU.  ``quantize`` (``configs.QUANT_MODES``,
    ``RM_QUANTIZE``) quantizes the layer stack once, after the model is
    placed and cast."""

    def __init__(
        self,
        model_name: str = "deberta-v3-base",
        *,
        model: Optional[deberta.DebertaModel] = None,
        config: Optional[DebertaConfig] = None,
        tokenizer: Optional[BaseTokenizer] = None,
        device=None,
        dtype: Optional[torch.dtype] = None,
        max_tokens: int = 512,
        seed: int = 0,
        quantize: str = "none",
    ) -> None:
        self.model_name = model_name
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        self.config = config or (
            model.config if model is not None else RM_PRESETS[model_name]
        )
        self.max_tokens = max_tokens
        self.tokenizer = tokenizer or load_tokenizer(
            vocab_size=self.config.vocab_size
        )
        if model is None:
            model = deberta.init_params(
                self.config, seed=seed, dtype=self.dtype, device=self.device
            )
        self.model = model.to(device=self.device, dtype=self.dtype)
        self.config = resolve_quantize(self.model, self.config, quantize)
        self._launch_lock = threading.Lock()

    def tokenize(self, texts: Iterable[str]):
        """texts -> ids/mask[N, S], S the ``_seq_bucket`` of the longest
        row, as the embedder buckets."""
        ids, mask = self.tokenizer.encode_batch(list(texts), self.max_tokens)
        seq = _seq_bucket(int(mask.sum(axis=1).max(initial=1)), self.max_tokens)
        return ids[:, :seq], mask[:, :seq]

    @torch.inference_mode()
    def confidence_tokens(
        self,
        ids: np.ndarray,
        mask: np.ndarray,
        temperature: float = DEFAULT_RM_TEMPERATURE,
    ) -> np.ndarray:
        """ids/mask[N, S] -> confidence[N] = softmax(reward / T): the
        reward and the vote in one forward, one upload and one copy
        back.  The copy back waits outside the launch lock, so the next
        request's launches queue behind this one's on the card."""
        flat = torch.from_numpy(
            np.ascontiguousarray(np.stack([ids, mask]), np.int32)
        )
        with self._launch_lock:
            flat = flat.to(self.device)
            rewards = deberta.reward(self.model, flat[0], flat[1])
            conf = deberta.reward_consensus_vote(rewards, float(temperature))
        return conf.cpu().numpy()

    def rerank_confidence(
        self,
        texts: list,
        prompt: Optional[str] = None,
        temperature: float = DEFAULT_RM_TEMPERATURE,
    ):
        """N candidate texts -> (confidence[N], token_count).  A
        ``prompt`` (the question answered) is prepended to every candidate
        as ``f"{prompt}\\n{text}"``: reward models score (prompt,
        candidate) pairs."""
        if prompt:
            texts = [f"{prompt}\n{text}" for text in texts]
        ids, mask = self.tokenize(texts)
        return self.confidence_tokens(ids, mask, temperature), int(mask.sum())
