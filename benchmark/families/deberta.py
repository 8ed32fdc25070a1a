"""The DeBERTa-v3 reward model family (``deberta-v3-base``): HF
``DebertaV2ForSequenceClassification`` with one label, served by the
port's ``TorchReranker`` behind the ``rm`` vote, judged by
``reference/deberta.py``."""

from __future__ import annotations

from benchmark import cost
from benchmark.families import common
from benchmark.reference import deberta as reference
from benchmark.reference import vote
from benchmark.reference.unigram import Unigram


def shapes(cfg: dict) -> list:
    """[(HF name, shape)] of a ``DebertaV2ForSequenceClassification``
    with one label, its backbone unprefixed."""
    h, i = cfg["hidden_size"], cfg["intermediate_size"]
    span = cfg["position_buckets"]
    if span <= 0:
        span = cfg["max_relative_positions"]
        if span < 1:
            span = cfg["max_position_embeddings"]
    out = [("embeddings.word_embeddings.weight", (cfg["vocab_size"], h)),
           ("embeddings.LayerNorm.weight", (h,)),
           ("embeddings.LayerNorm.bias", (h,)),
           ("encoder.rel_embeddings.weight", (2 * span, h)),
           ("encoder.LayerNorm.weight", (h,)),
           ("encoder.LayerNorm.bias", (h,))]
    for n in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{n}"
        for name, rows, cols in (
                ("attention.self.query_proj", h, h),
                ("attention.self.key_proj", h, h),
                ("attention.self.value_proj", h, h),
                ("attention.output.dense", h, h),
                ("intermediate.dense", i, h), ("output.dense", h, i)):
            out += [(f"{p}.{name}.weight", (rows, cols)),
                    (f"{p}.{name}.bias", (rows,))]
            if name in ("attention.output.dense", "output.dense"):
                ln = name.replace("dense", "LayerNorm")
                out += [(f"{p}.{ln}.weight", (h,)), (f"{p}.{ln}.bias", (h,))]
    out += [("pooler.dense.weight", (h, h)), ("pooler.dense.bias", (h,)),
            ("classifier.weight", (1, h)), ("classifier.bias", (1,))]
    return out


def make_state(cfg: dict, seed: int, device, dtype) -> dict:
    """LayerNorm scales 1, biases 0, every other tensor N(0,
    ``init_std``), in one draw (``common.draw_in_one_buffer``)."""
    return common.draw_in_one_buffer(shapes(cfg), common.layer_norm_kind,
                                     cfg["init_std"], seed, device, dtype)


def port_config(cfg: dict):
    from llm_weighted_consensus_tpu_torch.models.configs import DebertaConfig

    max_rel = cfg["max_relative_positions"]
    if max_rel < 1:
        max_rel = cfg["max_position_embeddings"]
    return DebertaConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_relative_positions=max_rel,
        position_buckets=cfg["position_buckets"],
        layer_norm_eps=cfg["layer_norm_eps"])


def port_tokenizer(cfg: dict):
    """The configuration's unigram pieces in the port's tokenizer, in
    DeBERTa's id scheme."""
    from llm_weighted_consensus_tpu_torch.models import spm

    kinds = {"normal": spm.NORMAL, "control": spm.CONTROL,
             "unknown": spm.UNKNOWN}
    return spm.UnigramTokenizer(
        [(p, float(s), kinds[k]) for p, s, k in cfg["vocab"]["pieces"]],
        scheme="deberta")


def build(cfg: dict, state: dict, device, dtype, quantize: str) -> tuple:
    """(None, reranker): ``deberta.from_hf_weights`` on the weights,
    wrapped in the served ``TorchReranker``."""
    from llm_weighted_consensus_tpu_torch.models import deberta
    from llm_weighted_consensus_tpu_torch.models.reranker import (
        TorchReranker)

    config = port_config(cfg)
    model = deberta.from_hf_weights(common.host_float32(state), config,
                                    dtype=dtype, device=device)
    return None, TorchReranker(
        cfg["name"], model=model, config=config,
        tokenizer=port_tokenizer(cfg), dtype=dtype, device=device,
        quantize=quantize)


def reference_tokenizer(cfg: dict):
    return Unigram(cfg["vocab"]["pieces"])


def max_tokens(cfg: dict) -> int:
    return 512


def reference_state(cfg: dict, state: dict, device) -> dict:
    return common.float32_copy(state, device)


def reference_scores(cfg: dict, ref_state: dict, ids, mask, device):
    """Each row's reward, centred."""
    return vote.reward_scores(reference.rewards(ref_state, cfg, ids, mask))


def request_flops(cfg: dict, lengths: list) -> float:
    return (sum(cost.deberta_sequence_flops(cfg, n) for n in lengths)
            + cost.deberta_table_flops(cfg))


attention_bound = common.attention_per_layer


def control(cfg: dict) -> str:
    """W8A8 in every dense layer of the encoder: the precision under
    bf16."""
    return "int8"
