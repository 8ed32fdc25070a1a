"""Served reward-model re-ranking: ``/consensus {"scorer": "rm"}``.

Counterpart of ``llm_weighted_consensus_tpu/models/reranker.py``'s
``TpuReranker``: candidates are tokenized on the host (SentencePiece
unigram for real checkpoints, the hash tokenizer for shape work), the
DeBERTa reward model scores each (prompt, candidate) pair on the device,
and ``softmax(reward / T)`` over the request's candidates is the
confidence, in the same forward.

There is no micro-batching: the softmax normalizes over exactly one
request's candidates, so each request runs on its own, on the server's
handler thread.  One forward issues its launches at a time, under the
device's launch lock (``models.graphs.launch_lock``): eager launches
from concurrent threads contend for the interpreter lock at every op,
which cost more than half the served throughput on an H100
(``PERF.md``).  Under a quantize mode the six content and MLP dense
layers of every layer run the W8A8 / W4A8 kernels (``models.quant``).

``warmup`` captures one CUDA graph of ``deberta.reward`` per (N, S)
bucket (``RM_WARMUP``), where the reference jit-compiles per static N; a
request at a warmed bucket then holds the lock for one copy-in, one
replay, the softmax (outside the graph: its temperature is a run-time
value) and the copy back, and ``graph_stats`` counts it.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from . import deberta
from .bert import default_dtype, resolve_device
from .configs import DEBERTA_TEST_TINY, DEBERTA_V3_BASE, DebertaConfig
from .dispatch_seam import StagingPool
from .embedder import _seq_bucket
from .graphs import GraphTable, warm_rows
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
    placed and cast.  ``staging_buffers`` (``STAGING_BUFFERS``) caps the
    pinned staging buffers kept per bucket."""

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
        staging_buffers: int = 2,
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
        self.graphs = GraphTable(self.device)
        # the mesh (``attach_mesh``, MESH_ENABLED)
        self.mesh = None
        self.mesh_model = None
        self.staging_pool = StagingPool(
            per_bucket=staging_buffers, pin=self.device.type == "cuda"
        )
        self.device_timing = True

    def attach_mesh(self, mesh) -> None:
        """The reward model's params on ``mesh`` by the DeBERTa rule table
        (``parallel.sharding.shard_reranker_mesh``): with tp past 1 the
        layers and the head run tensor-parallel
        (``deberta.reward_mesh``); the batch stays unsharded, on the
        mesh's first dp row, whose first device must be the reranker's.
        Across cards the graphs are off (a graph captures one device)."""
        from ..parallel.mesh import same_device
        from ..parallel.sharding import MeshModel, deberta_partition_rules
        from .quant import is_quantized

        if not same_device(mesh.device(), self.device):
            raise ValueError(
                f"the mesh's first device {mesh.device()} is not the "
                f"reranker's {self.device}"
            )
        tp = mesh.shape.get("tp", 1)
        rules = deberta_partition_rules(quantized=is_quantized(self.model))
        self.mesh_model = MeshModel(self.model, mesh, rules, tp=tp > 1)
        self.mesh = mesh
        self.graphs.capture = mesh.on_one_device()

    def _forward(self, ids, mask):
        if self.mesh_model is not None and self.mesh_model.tp > 1:
            return deberta.reward_mesh(self.mesh_model, ids, mask)
        return deberta.reward(self.model, ids, mask)

    def warmup(self, specs: list) -> list:
        """Capture the reward forward ``("rm", N, S)`` for every (N, S)
        spec, S snapped to the serving sequence bucket (on the CPU the
        keys are recorded, nothing is captured).  Returns [(label,
        seconds)] for the buckets warmed by this call."""
        buckets = [(n, _seq_bucket(s, self.max_tokens)) for n, s in specs]
        timings = [self.graphs.warm(("rm", n, s), warm_rows(n, s),
                                    self._forward) for n, s in buckets]
        return [t for t in timings if t is not None]

    def graph_stats(self) -> dict:
        return self.graphs.stats()

    def tokenize(self, texts: Iterable[str]):
        """texts -> ids/mask[N, S], S the ``_seq_bucket`` of the longest
        row, as the embedder buckets."""
        ids, mask = self.tokenizer.encode_batch(list(texts), self.max_tokens)
        seq = _seq_bucket(int(mask.sum(axis=1).max(initial=1)), self.max_tokens)
        return ids[:, :seq], mask[:, :seq]

    def confidence_tokens(
        self,
        ids: np.ndarray,
        mask: np.ndarray,
        temperature: float = DEFAULT_RM_TEMPERATURE,
    ) -> np.ndarray:
        """ids/mask[N, S] -> confidence[N] = softmax(reward / T): the
        reward (a graph replay at a warmed ``("rm", N, S)``) and the vote
        in one dispatch, one upload and one copy back.  The copy back is
        waited for outside the launch lock, so the next request's
        launches queue behind this one's on the card."""
        n, s = ids.shape
        temperature = float(temperature)
        return self.graphs.dispatch(
            ("rm", n, s), f"rm(n={n},s={s})", {"ids": ids, "mask": mask},
            self._forward,
            lambda rewards: deberta.reward_consensus_vote(rewards,
                                                          temperature),
            self.staging_pool, timed=self.device_timing,
        )

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
