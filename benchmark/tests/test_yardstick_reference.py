"""The plain reference against the port's CPU path, on the same weights
at the test sizes: the tokenizers id for id, the encoders' scores within
float32 rounding.  And pinned, for both configurations at the CPU size:
the seeded weights (a hash of every tensor) and the reference's scores
of a fixed request, read before the harness loaded a configuration's
family by name, and unchanged after."""

import hashlib

import pytest
import torch
import yardstick_helpers as h

from benchmark import check, spec, weights
from benchmark.reference import bert as ref_bert
from benchmark.reference import deberta as ref_deberta
from benchmark.reference import vote
from benchmark.reference.unigram import Unigram
from benchmark.reference.wordpiece import WordPiece

TEXTS = ["The answer is 42, therefore we get 42.",
         "Résumé: compute the final value; so 41!",
         "because   number\tresult 7x", "zzqq unknownword so"]


def test_wordpiece_matches_the_ports():
    cfg = h.cell(h.COSINE).cfg
    ours = WordPiece(cfg["vocab"]["tokens"])
    port = spec.family("bert").port_tokenizer(cfg)
    for text in TEXTS:
        assert ours.encode(text, 64) == port._encode(text, 64)


def test_unigram_matches_the_ports():
    cfg = h.cell(h.RM).cfg
    ours = Unigram(cfg["vocab"]["pieces"])
    port = spec.family("deberta").port_tokenizer(cfg)
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
    family = spec.family("bert")
    config = family.port_config(cfg)
    emb = TorchEmbedder("tiny", model=bert.from_hf_state_dict(
        dict(state), config, dtype=torch.float32, device="cpu"),
        config=config, tokenizer=family.port_tokenizer(cfg), device="cpu")
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

    family = spec.family("deberta")
    for buckets in (0, 8):
        cfg = h.cell(h.RM).cfg
        cfg.update(max_relative_positions=16, position_buckets=buckets)
        state = weights.make_state(cfg, seed, "cpu", torch.float32)
        model = deberta.from_hf_weights(dict(state),
                                        family.port_config(cfg),
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


def state_hash(state: dict) -> str:
    """sha256 over every tensor's name, shape, dtype and values, in the
    state dict's order."""
    d = hashlib.sha256()
    for name, t in state.items():
        d.update(f"{name}:{tuple(t.shape)}:{t.dtype};".encode())
        d.update(t.detach().float().contiguous().numpy().tobytes())
    return d.hexdigest()


PINNED_SEED = 2 ** 31 + 17
STATES = [
    (h.COSINE, "float32",
     "b2e8b0244bc9b57f8684a60942ecdc39ec3ac149dd5f4197ea1721631210fb36"),
    (h.COSINE, "bfloat16",
     "b55d6f9b008ccc06c5df4917fc8f2ed17defd1563cdf3eaf1b2bcdbcac30f912"),
    (h.RM, "float32",
     "1689c7ea9bbcbdacc4873d575d21defafde2669d8786017336c8ee21e5d65799"),
    (h.RM, "bfloat16",
     "1889e98ec9e9d72a4720ea593e8385f552664dd427558a72032f8f42fb50ea34"),
]


@pytest.mark.parametrize("name,dtype,want", STATES)
def test_pinned_seeded_state(name, dtype, want):
    cfg = h.cell(name).cfg
    state = weights.make_state(cfg, PINNED_SEED, "cpu", getattr(torch, dtype))
    assert state_hash(state) == want


REQUEST = ["the answer is 42 so we get 42", "the value is 41 because",
           "compute the final result; the number is 42",
           "so we get the answer 41", "therefore 42"]
SCORES = {
    h.COSINE: ([0.0004058139370645142, 0.0002607470788057453,
                0.0007648698377259455, 0.0005762580984357557,
                -0.0020076889520318497], 40),
    h.RM: ([-0.0011196292936801883, 9.855553507805148e-05,
            0.0023558095097541837, 0.0005621939897537259,
            -0.001896929740905759], 55),
}


def pinned_scores(name: str) -> tuple:
    cfg = h.cell(name).cfg
    state = weights.make_state(cfg, PINNED_SEED, "cpu", torch.float32)
    texts = REQUEST if name == h.COSINE else [
        f"the answer is\n{t}" for t in REQUEST]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scores, tokens = check.reference_scores(
            cfg, state, check.reference_tokenizer(cfg), texts, "cpu")
    finally:
        torch.set_num_threads(threads)
    return scores.tolist(), tokens


@pytest.mark.parametrize("name", [h.COSINE, h.RM])
def test_pinned_reference_scores(name):
    scores, tokens = pinned_scores(name)
    want, want_tokens = SCORES[name]
    assert tokens == want_tokens
    assert scores == pytest.approx(want, rel=0, abs=1e-12)
