"""The comparison catches a broken timed path.  The whole run is driven
on the CPU (the harness's look for a card skipped), with the program
broken underneath, and ``correct`` has to come out false for each fault
the cosine cells can have:

* a step that returns its state unchanged: every dispatch's vote returns
  the first answer it ever gave;
* half of the batch left out, the mean taken over the rest: each
  candidate's mean similarity over the first half of the candidates;
* an answer altered where it is produced: two candidates' confidences
  swapped in every vote.

The exchange between chips does not exist in these one-card cells.  The
program is served in float32 here, so that the unbroken path reads
about 1e-3 of the scores' spread."""

import pytest
import torch
import yardstick_helpers as h

import llm_weighted_consensus_tpu_torch.models.embedder as embedder_mod

ORIGINAL = embedder_mod.cosine_vote


def stale_vote():
    first = {}

    def vote(emb, n_valid=None, temperature=0.05):
        out = ORIGINAL(emb, n_valid, temperature)
        return first.setdefault(tuple(out.shape), out).clone()
    return vote


def half_vote():
    def vote(emb, n_valid=None, temperature=0.05):
        x = emb.float()
        x = x / x.norm(dim=-1, keepdim=True)
        sims = x @ x.transpose(-1, -2)
        n = x.shape[-2]
        pairs = (torch.arange(n) < n // 2)[None, :] & ~torch.eye(
            n, dtype=torch.bool)
        mean = (sims * pairs).sum(-1) / pairs.sum(-1)
        return torch.softmax(mean / temperature, dim=-1)
    return vote


def swapped_vote():
    def vote(emb, n_valid=None, temperature=0.05):
        out = ORIGINAL(emb, n_valid, temperature).clone()
        out[..., [0, 1]] = out[..., [1, 0]]
        return out
    return vote


@pytest.mark.parametrize("fault", ["stale", "half", "swapped"])
def test_a_broken_path_is_not_correct(fault, monkeypatch):
    vote = {"stale": stale_vote, "half": half_vote,
            "swapped": swapped_vote}[fault]()
    monkeypatch.setattr(embedder_mod, "cosine_vote", vote)
    out = h.run(h.cell(h.COSINE, candidates=8, clients=4), seconds=1.5)
    assert out["checks"]["checked"]["value"] >= 1
    assert not out["correct"], out["checks"]


def test_the_unbroken_path_is_correct():
    out = h.run(h.cell(h.COSINE, candidates=8, clients=4), seconds=1.5)
    assert out["correct"], out["checks"]
