"""The learning-effect scenario: trained weights improve consensus
accuracy (the port's copy of the helpers ``tests/test_learning_effect.py``
shares with the reference's ``bench_all.py``, config 6).

Two topics of prompts (distinct vocabulary, so their embeddings
cluster); judge "alpha-expert" votes the right candidate on alpha prompts
and the wrong one on beta prompts, "beta-expert" the mirror image.  A
supervised archive is learned into training tables
(``weights.learning.populate_from_archive``), and on held-out prompts the
learned per-judge weights steer the tally (``ops.consensus.tally``) to
the planted truth more often than static equal weights do.
"""

from __future__ import annotations

import asyncio

import numpy as np

TOPIC_WORDS = {
    "alpha": "arithmetic sums integers count total add",
    "beta": "poetry meter rhyme stanza verse lyric",
}
CANDIDATES = ["four", "five"]
EMBEDDINGS = {"model": "test-tiny", "max_tokens": 32}


def make_embedder(device=None):
    from ..models import configs
    from ..models.embedder import TorchEmbedder

    return TorchEmbedder("test-tiny", config=configs.TEST_TINY, max_tokens=32,
                         seed=1, device=device)


def make_panel():
    from ..identity.model import ModelBase

    return ModelBase.from_json_obj({
        "llms": [
            {"model": name,
             "weight": {"type": "training_table", "base_weight": 1,
                        "min_weight": 1, "max_weight": 5}}
            for name in ("alpha-expert", "beta-expert")
        ],
        "weight": {"type": "training_table", "embeddings": EMBEDDINGS,
                   "top": 3},
    }).into_model_validate()


def prompt_text(topic: str, i: int) -> str:
    words = TOPIC_WORDS[topic].split()
    return f"{topic} question {i}: " + " ".join(
        words[(i + j) % len(words)] for j in range(4))


def judge_vote(judge_name: str, topic: str, correct: int) -> list:
    """The topic's expert votes the truth, the other the other one."""
    pick = correct if judge_name.split("-")[0] == topic else 1 - correct
    return [1 if i == pick else 0 for i in range(len(CANDIDATES))]


def make_params(model, prompt: str):
    from ..types import score_request

    return score_request.ChatCompletionCreateParams.from_json_obj({
        "messages": [{"role": "user", "content": prompt}],
        "model": {
            "llms": [llm.base.to_json_obj() for llm in model.llms],
            "weight": {"type": "training_table", "embeddings": EMBEDDINGS,
                       "top": 3},
        },
        "choices": list(CANDIDATES),
    })


def archived_completion(cid: str, model, topic: str, correct: int):
    """A scored completion as the score client writes it: the N
    candidates (model_index null), then one choice per judge carrying its
    vote."""
    from ..types import score_response

    n = len(CANDIDATES)
    choices = [
        {"index": i, "message": {"role": "assistant", "content": text},
         "confidence": 1.0 / n, "model_index": None, "model": None}
        for i, text in enumerate(CANDIDATES)
    ]
    for llm in model.llms:
        choices.append({
            "index": n + llm.index,
            "message": {"role": "assistant", "content": "voted",
                        "vote": judge_vote(llm.base.model, topic, correct)},
            "model_index": llm.index,
            "model": llm.id,
        })
    return score_response.ChatCompletion.from_json_obj({
        "id": cid, "created": 0, "model": "panel",
        "object": "chat.completion", "choices": choices,
    })


def build_archive(model, n_per_topic: int):
    from .. import archive

    store = archive.InMemoryArchive()
    labels = {}
    k = 0
    for topic in ("alpha", "beta"):
        for i in range(n_per_topic):
            correct = k % 2  # alternate: neither candidate is a prior
            cid = f"scrcpl-learn-{topic}-{i}"
            store.put_score(archived_completion(cid, model, topic, correct))
            store.put_score_request(cid,
                                    make_params(model, prompt_text(topic, i)))
            labels[cid] = correct
            k += 1
    return store, labels


def tally_top1(weights, votes, device) -> int:
    from ..ops.consensus import tally

    _, confidence = tally(np.asarray(votes, np.float32),
                          np.asarray(weights, np.float32), device=device)
    return int(np.argmax(confidence.cpu().numpy()))


def evaluate_held_out(fetcher, model, n_train: int, per_topic: int = 12,
                      device=None):
    """(learned accuracy, static accuracy, prompts, all weights) over
    both topics' held-out prompts."""
    loop = asyncio.new_event_loop()
    try:
        learned_hits = static_hits = total = 0
        all_weights = []
        ordered = sorted(model.llms, key=lambda llm: llm.index)
        for topic in ("alpha", "beta"):
            for i in range(n_train, n_train + per_topic):
                correct = total % 2
                params = make_params(model, prompt_text(topic, i))
                weights, _ = loop.run_until_complete(
                    fetcher.fetch(None, params, model))
                all_weights.extend(weights)
                votes = [judge_vote(llm.base.model, topic, correct)
                         for llm in ordered]
                w = [float(weights[llm.index]) for llm in ordered]
                learned_hits += tally_top1(w, votes, device) == correct
                static_hits += tally_top1([1.0] * len(w), votes,
                                          device) == correct
                total += 1
    finally:
        loop.close()
    return learned_hits / total, static_hits / total, total, all_weights
