"""The plain reference against the port's CPU path, on the same weights
at the test sizes: the tokenizers id for id, the encoders' scores within
float32 rounding."""

import pytest
import torch
import yardstick_helpers as h

from benchmark import weights
from benchmark.reference import bert as ref_bert
from benchmark.reference import deberta as ref_deberta
from benchmark.reference import vote
from benchmark.reference.unigram import Unigram
from benchmark.reference.wordpiece import WordPiece
from benchmark.system import _bert_config, _deberta_config, _tokenizer

TEXTS = ["The answer is 42, therefore we get 42.",
         "Résumé: compute the final value; so 41!",
         "because   number\tresult 7x", "zzqq unknownword so"]


def test_wordpiece_matches_the_ports():
    cfg = h.cell(h.COSINE).cfg
    ours, port = WordPiece(cfg["vocab"]["tokens"]), _tokenizer(cfg["vocab"])
    for text in TEXTS:
        assert ours.encode(text, 64) == port._encode(text, 64)


def test_unigram_matches_the_ports():
    cfg = h.cell(h.RM).cfg
    ours, port = Unigram(cfg["vocab"]["pieces"]), _tokenizer(cfg["vocab"])
    for text in TEXTS + ["the answer\nis 42"]:
        assert ours.encode(text, 64) == port._encode(text, 64)


def _batch(tok, texts):
    rows = [tok.encode(t, 512) for t in texts]
    s = max(map(len, rows))
    ids = torch.zeros((len(rows), s), dtype=torch.long)
    mask = torch.zeros_like(ids)
    for i, r in enumerate(rows):
        ids[i, :len(r)], mask[i, :len(r)] = torch.tensor(r), 1
    return ids, mask


TEXTS8 = ["the answer is 42 so we get 42", "the value is 41",
          "compute the final result because the number is 42",
          "so we get the answer", "41 41 41 therefore", "final final value",
          "we compute so the answer is", "because we get 42"]


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5])
def test_bert_scores_match_the_port(seed):
    from llm_weighted_consensus_tpu_torch.models import bert
    from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder

    cfg = h.cell(h.COSINE).cfg
    state = weights.make_state(cfg, seed, "cpu", torch.float32)
    config = _bert_config(cfg)
    emb = TorchEmbedder("tiny", model=bert.from_hf_state_dict(
        dict(state), config, dtype=torch.float32, device="cpu"),
        config=config, tokenizer=_tokenizer(cfg["vocab"]), device="cpu")
    got = emb.consensus_confidence(TEXTS8, temperature=0.05)
    tok = WordPiece(cfg["vocab"]["tokens"])
    ids, mask = _batch(tok, TEXTS8)
    want = vote.cosine_scores(ref_bert.sentence_vectors(state, cfg, ids,
                                                        mask))
    served = vote.served_scores([float(c) for c in got], 0.05)
    assert torch.allclose(served, want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 6])
def test_deberta_rewards_match_the_port(seed):
    from llm_weighted_consensus_tpu_torch.models import deberta

    for buckets in (0, 8):
        cfg = h.cell(h.RM).cfg
        cfg.update(max_relative_positions=16, position_buckets=buckets)
        state = weights.make_state(cfg, seed, "cpu", torch.float32)
        model = deberta.from_hf_weights(dict(state), _deberta_config(cfg),
                                        dtype=torch.float32, device="cpu")
        tok = Unigram(cfg["vocab"]["pieces"])
        texts = [f"the answer is\n{t}" for t in TEXTS8]
        ids, mask = _batch(tok, texts)
        got = deberta.reward(model, ids.int(), mask.int())
        want = ref_deberta.rewards(state, cfg, ids, mask)
        assert torch.allclose(got, want.float(), atol=2e-5, rtol=1e-5)


def test_relative_positions_are_hf_log_buckets():
    rel = ref_deberta.relative_positions(512, 256, 512, "cpu")
    assert rel[0, 0] == 0 and rel[5, 0] == 5 and rel[0, 128] == -128
    assert rel[511, 0] == 255 and rel[0, 511] == -255
    assert torch.equal(rel, -rel.T)
