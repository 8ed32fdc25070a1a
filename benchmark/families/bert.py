"""The BERT encoder family (``bge-large-en``): HF ``BertModel`` without
its pooler, served by the port's ``TorchEmbedder`` behind the cosine
vote, judged by ``reference/bert.py``."""

from __future__ import annotations

from benchmark import cost
from benchmark.families import common
from benchmark.reference import bert as reference
from benchmark.reference import vote
from benchmark.reference.wordpiece import WordPiece


def shapes(cfg: dict) -> list:
    """[(HF name, shape)] of a ``BertModel`` without its pooler."""
    h, i = cfg["hidden_size"], cfg["intermediate_size"]
    out = [("embeddings.word_embeddings.weight", (cfg["vocab_size"], h)),
           ("embeddings.position_embeddings.weight",
            (cfg["max_position_embeddings"], h)),
           ("embeddings.token_type_embeddings.weight",
            (cfg["type_vocab_size"], h)),
           ("embeddings.LayerNorm.weight", (h,)),
           ("embeddings.LayerNorm.bias", (h,))]
    for n in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{n}"
        for name, rows, cols in (
                ("attention.self.query", h, h), ("attention.self.key", h, h),
                ("attention.self.value", h, h),
                ("attention.output.dense", h, h),
                ("intermediate.dense", i, h), ("output.dense", h, i)):
            out += [(f"{p}.{name}.weight", (rows, cols)),
                    (f"{p}.{name}.bias", (rows,))]
            if name in ("attention.output.dense", "output.dense"):
                ln = name.replace("dense", "LayerNorm")
                out += [(f"{p}.{ln}.weight", (h,)), (f"{p}.{ln}.bias", (h,))]
    return out


def make_state(cfg: dict, seed: int, device, dtype) -> dict:
    """LayerNorm scales 1, biases 0, every other tensor N(0,
    ``init_std``), in one draw (``common.draw_in_one_buffer``)."""
    return common.draw_in_one_buffer(shapes(cfg), common.layer_norm_kind,
                                     cfg["init_std"], seed, device, dtype)


def port_config(cfg: dict):
    from llm_weighted_consensus_tpu_torch.models.configs import BertConfig

    return BertConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_position_embeddings=cfg["max_position_embeddings"],
        type_vocab_size=cfg["type_vocab_size"],
        layer_norm_eps=cfg["layer_norm_eps"],
        pad_token_id=cfg["pad_token_id"], pooling=cfg["pooling"])


def port_tokenizer(cfg: dict):
    """The configuration's WordPiece vocabulary in the port's tokenizer."""
    from llm_weighted_consensus_tpu_torch.models.tokenizer import (
        WordPieceTokenizer)

    return WordPieceTokenizer({t: i for i, t in
                               enumerate(cfg["vocab"]["tokens"])})


def build(cfg: dict, state: dict, device, dtype, quantize: str) -> tuple:
    """(embedder, None): ``bert.from_hf_state_dict`` on the weights,
    wrapped in the served ``TorchEmbedder``."""
    from llm_weighted_consensus_tpu_torch.models import bert
    from llm_weighted_consensus_tpu_torch.models.embedder import (
        TorchEmbedder)

    config = port_config(cfg)
    model = bert.from_hf_state_dict(common.host_float32(state), config,
                                    dtype=dtype, device=device)
    return TorchEmbedder(
        cfg["name"], model=model, config=config,
        tokenizer=port_tokenizer(cfg), dtype=dtype, device=device,
        quantize=quantize), None


def reference_tokenizer(cfg: dict):
    return WordPiece(cfg["vocab"]["tokens"])


def max_tokens(cfg: dict) -> int:
    return 512


def reference_state(cfg: dict, state: dict, device) -> dict:
    return common.float32_copy(state, device)


def reference_scores(cfg: dict, ref_state: dict, ids, mask, device):
    """The centred mean cosine similarity of each row's sentence vector."""
    return vote.cosine_scores(reference.sentence_vectors(ref_state, cfg,
                                                         ids, mask))


def request_flops(cfg: dict, lengths: list) -> float:
    return sum(cost.bert_sequence_flops(cfg, n) for n in lengths)


attention_bound = common.attention_per_layer


def control(cfg: dict) -> str:
    """W8A8 in every dense layer: the precision under bf16."""
    return "int8"
