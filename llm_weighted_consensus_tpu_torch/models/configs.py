"""Encoder configurations: ``BertConfig`` with the BERT-family presets,
and ``DebertaConfig`` with the reward model's.

Counterpart of ``llm_weighted_consensus_tpu/models/configs.py``, with the
same field names and preset values.  Left out: ``attention_impl`` and
``ring_axis`` (the port's attention is the CUDA kernel on the card and
its plain version on the CPU, nothing else).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    # family-default pooling: bge uses CLS, e5/gte use masked mean
    # (both + l2-normalize); TorchEmbedder reads this unless overridden
    pooling: str = "cls"
    # "absolute": positions 0..s-1 (BERT).  "roberta": positions start at
    # pad_token_id+1 (XLM-R/RoBERTa checkpoints, e.g. bge-m3) — with the
    # framework's left-aligned masks that is an arange offset, so the
    # usable window is max_position_embeddings - pad_token_id - 1.
    position_style: str = "absolute"
    # "none" = dense layers in the param dtype; a quantized mode (see
    # QUANT_MODES) is stamped by models.quant.resolve_quantize when the
    # layer stack's dense layers are replaced by quantized ones
    quantize: str = "none"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


# the reference's mode strings.  "int8", "int8-pallas" and "int4-pallas"
# run the hand-written W8A8 / W4A8 kernels on the card (their plain
# versions on the CPU); "int8-xla" pins an XLA composition the port does
# not have and is refused (models.quant.resolve_quantize).
QUANT_MODES = ("none", "int8", "int8-pallas", "int8-xla", "int4-pallas")


# BGE family (BAAI/bge-*-en-v1.5 shapes; CLS pooling)
BGE_SMALL = BertConfig(
    hidden_size=384, num_layers=12, num_heads=12, intermediate_size=1536
)
BGE_BASE = BertConfig(
    hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072
)
BGE_LARGE = BertConfig(
    hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096
)

# E5 family (intfloat/e5-*-v2: BERT arch, masked-MEAN pooling, "query:"/
# "passage:" input prefixes are the caller's concern)
E5_SMALL = BertConfig(
    hidden_size=384, num_layers=12, num_heads=12, intermediate_size=1536,
    pooling="mean",
)
E5_BASE = BertConfig(
    hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072,
    pooling="mean",
)
E5_LARGE = BertConfig(
    hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096,
    pooling="mean",
)

# GTE family (thenlper/gte-*: BERT arch, masked-MEAN pooling)
GTE_SMALL = BertConfig(
    hidden_size=384, num_layers=12, num_heads=12, intermediate_size=1536,
    pooling="mean",
)
GTE_BASE = BertConfig(
    hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072,
    pooling="mean",
)
GTE_LARGE = BertConfig(
    hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096,
    pooling="mean",
)

# BGE-M3 (BAAI/bge-m3 dense retrieval: XLM-RoBERTa-large arch, 8192-token
# context, CLS pooling).  Positions are roberta-style; the 8194-row table
# minus pad_token_id+1 gives the advertised 8192-token window.  Serve long
# inputs with MESH_SP (ring attention).  The checkpoint's
# sentencepiece.bpe.model tokenizes via models/spm.py (xlmr id scheme,
# auto-discovered next to EMBEDDER_WEIGHTS or set EMBEDDER_VOCAB).
BGE_M3 = BertConfig(
    vocab_size=250002,
    hidden_size=1024,
    num_layers=24,
    num_heads=16,
    intermediate_size=4096,
    max_position_embeddings=8194,
    type_vocab_size=1,
    pad_token_id=1,
    position_style="roberta",
)

# Long-context encoder (bge-large dims, 8192-position table): serve with
# MESH_SP so attention runs as a sequence-parallel ring — a single device
# would need the full (s, s) score matrix.  No public checkpoint ships
# with these positions; load fine-tuned weights via EMBEDDER_WEIGHTS or
# train with train/ (position_embed rows beyond 512 train from scratch).
BERT_LONG_8K = BertConfig(
    hidden_size=1024,
    num_layers=24,
    num_heads=16,
    intermediate_size=4096,
    max_position_embeddings=8192,
)

# tiny config for tests: fast init/compile on the CPU mesh
TEST_TINY = BertConfig(
    vocab_size=512,
    hidden_size=64,
    num_layers=2,
    num_heads=4,
    intermediate_size=128,
    max_position_embeddings=64,
)

PRESETS = {
    "bge-small-en": BGE_SMALL,
    "bge-base-en": BGE_BASE,
    "bge-large-en": BGE_LARGE,
    "e5-small-v2": E5_SMALL,
    "e5-base-v2": E5_BASE,
    "e5-large-v2": E5_LARGE,
    "gte-small": GTE_SMALL,
    "gte-base": GTE_BASE,
    "gte-large": GTE_LARGE,
    "bge-m3": BGE_M3,
    "bert-long-8k": BERT_LONG_8K,
    "test-tiny": TEST_TINY,
}


def position_base(config: BertConfig) -> int:
    """First position id of a left-aligned sequence (0 for BERT,
    pad_token_id+1 for roberta-style checkpoints)."""
    return (
        config.pad_token_id + 1
        if config.position_style == "roberta"
        else 0
    )


def usable_positions(config: BertConfig) -> int:
    """Longest sequence the position table supports."""
    return config.max_position_embeddings - position_base(config)


@dataclass(frozen=True)
class DebertaConfig:
    """DeBERTa-style encoder with disentangled relative attention (the
    reward model behind ``/consensus {"scorer": "rm"}``).

    ``position_buckets > 0`` selects DeBERTa-v3's log-bucketed relative
    positions (HF ``make_log_bucket_position``: exact within
    +-buckets/2, log-spaced beyond, out to ``max_relative_positions``;
    relative table rows = 2 x buckets), the scheme every released v3
    checkpoint is trained with.  ``position_buckets = 0`` is the plain
    clamp scheme (rows = 2 x max_relative_positions).
    """

    vocab_size: int = 128100
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_relative_positions: int = 512  # furthest distinguishable distance
    position_buckets: int = 256  # 0 = clamp scheme
    layer_norm_eps: float = 1e-7
    pad_token_id: int = 0
    # a QUANT_MODES value, stamped by models.quant.resolve_quantize: the
    # content and MLP dense layers as W8A8 / W4A8; the position
    # projections and the reward head stay full precision
    quantize: str = "none"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def att_span(self) -> int:
        """Half the relative-position table (HF ``pos_ebd_size``)."""
        return (
            self.position_buckets
            if self.position_buckets > 0
            else self.max_relative_positions
        )


# microsoft/deberta-v3-base shapes: max_relative_positions=-1 in HF
# resolves to max_position_embeddings (512); position_buckets=256
DEBERTA_V3_BASE = DebertaConfig()
DEBERTA_TEST_TINY = DebertaConfig(
    vocab_size=512,
    hidden_size=64,
    num_layers=2,
    num_heads=4,
    intermediate_size=128,
    max_relative_positions=16,
    position_buckets=0,
)
