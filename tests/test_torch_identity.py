"""The port's content-addressed ids against the reference's.

``llm_weighted_consensus_tpu_torch.identity`` hashes with its own
pure-Python XXH3-128 (``identity/xxh3.py``: the card's machine has no
``xxhash``).  It must equal ``xxhash.xxh3_128_intdigest`` bit for bit on
every length class of the algorithm (0, 1-3, 4-8, 9-16, 17-128, 129-240,
past 240 with and without a partial block or stripe) and on any split
of a streamed input, and every panel id (``Model.id``,
``multichat_id``, ``training_table_id``, each judge's ids) must equal the
JAX package's on seeded panels of 1 to 128 judges.  Exact equality.
"""

import json

import numpy as np
import pytest
import xxhash
from hypothesis import given, settings
from hypothesis import strategies as st

from llm_weighted_consensus_tpu.identity.model import ModelBase as RefModelBase
from llm_weighted_consensus_tpu_torch.identity import IncrementalHasher
from llm_weighted_consensus_tpu_torch.identity.model import ModelBase
from llm_weighted_consensus_tpu_torch.identity.xxh3 import (
    Xxh3_128,
    xxh3_128_intdigest,
)

# each class of the algorithm, its edges, and long inputs around the
# 1024-byte block and the 64-byte stripe
LENGTHS = sorted(
    {0, 1, 2, 3, 4, 5, 8, 9, 15, 16, 17, 31, 32, 33, 64, 65, 96, 97, 127,
     128, 129, 160, 161, 239, 240, 241, 255, 256, 319, 320, 1023, 1024,
     1025, 1087, 1088, 2048, 2049, 5000}
)


@pytest.mark.parametrize("n", LENGTHS)
def test_xxh3_128_equals_xxhash_at_every_length_class(n):
    rng = np.random.default_rng(n)
    for _ in range(4):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert xxh3_128_intdigest(data) == xxhash.xxh3_128_intdigest(data)
    for fill in (b"\x00", b"\xff"):
        assert xxh3_128_intdigest(fill * n) == xxhash.xxh3_128_intdigest(
            fill * n)


@settings(max_examples=150, deadline=None)
@given(st.binary(max_size=1500), st.data())
def test_streamed_updates_split_anywhere_give_the_one_shot_hash(data, draw):
    cuts = sorted(draw.draw(st.lists(
        st.integers(0, len(data)), max_size=6)))
    ours, theirs = Xxh3_128(), xxhash.xxh3_128(seed=0)
    start = 0
    for cut in cuts + [len(data)]:
        ours.update(data[start:cut])
        theirs.update(data[start:cut])
        start = cut
    assert ours.intdigest() == theirs.intdigest() == \
        xxhash.xxh3_128_intdigest(data)


def test_incremental_hasher_ids_match_xxhash():
    rng = np.random.default_rng(5)
    parts = ["".join(rng.choice(list("ab{}\":,é"), int(k)))
             for k in rng.integers(0, 300, 20)]
    h = IncrementalHasher()
    for part in parts:
        h.write(part)
    want = xxhash.xxh3_128_intdigest("".join(parts).encode("utf-8"))
    from llm_weighted_consensus_tpu_torch.identity import id_string

    assert h.finish_id() == id_string(want)


MODELS = ["openai/gpt-4o", "anthropic/claude-3.5-sonnet",
          "google/gemini-1.5-pro", "meta-llama/llama-3-70b", "gen-a"]


def _panel(rng, n_judges: int) -> dict:
    """A seeded panel: judges drawn from 5 models with sampling knobs,
    static weights (some Decimal-looking), duplicates included."""
    llms = []
    for _ in range(n_judges):
        judge = {"model": MODELS[int(rng.integers(0, len(MODELS)))]}
        if rng.random() < 0.5:
            judge["weight"] = {"type": "static",
                               "weight": float(rng.integers(1, 9)) / 2}
        if rng.random() < 0.4:
            judge["temperature"] = float(rng.integers(0, 20)) / 10
        if rng.random() < 0.2:
            judge["top_logprobs"] = int(rng.integers(1, 5))
            judge["output_mode"] = "json_schema"
        if rng.random() < 0.2:
            judge["stop"] = ["\n", "END"][: int(rng.integers(1, 3))]
        llms.append(judge)
    return {"llms": llms}


@pytest.mark.parametrize("n_judges", [1, 2, 3, 7, 16, 33, 64, 128])
def test_panel_ids_equal_the_reference(n_judges):
    rng = np.random.default_rng(n_judges)
    for _ in range(3):
        body = json.dumps(_panel(rng, n_judges))
        ref = RefModelBase.from_json(body).into_model_validate()
        port = ModelBase.from_json(body).into_model_validate()
        assert (port.id, port.multichat_id, port.training_table_id) == (
            ref.id, ref.multichat_id, ref.training_table_id)
        assert [(l.id, l.multichat_id, l.index, l.multichat_index)
                for l in port.llms] == [
            (l.id, l.multichat_id, l.index, l.multichat_index)
            for l in ref.llms]
        assert port.to_json() == ref.to_json()


def test_training_table_panel_ids_equal_the_reference():
    body = (
        '{"weight":{"type":"training_table","embeddings":{"model":'
        '"bge-small-en","max_tokens":512},"top":10},"llms":[{"model":"a",'
        '"weight":{"type":"training_table","base_weight":1.0,"min_weight":'
        '0.5,"max_weight":2.0}},{"model":"b","weight":{"type":'
        '"training_table","base_weight":1.0,"min_weight":0.5,'
        '"max_weight":2.0}}]}'
    )
    ref = RefModelBase.from_json(body).into_model_validate()
    port = ModelBase.from_json(body).into_model_validate()
    assert (port.id, port.multichat_id, port.training_table_id) == (
        ref.id, ref.multichat_id, ref.training_table_id)
    assert port.training_table_id is not None
