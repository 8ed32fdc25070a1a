"""The port's training-table learning (``weights/learning.py``) against the
JAX package's, on the CPU.

* ``judge_alignment_scores``: exactly the reference's scores
  (self-consistency and supervised, out-of-range labels, errored judges
  left out) on every archived completion;
* ``populate_from_archive`` on ``tests/fixtures/bge_micro`` (f32): the
  archive the JAX package built and saved, loaded by the port, learned by
  both packages' embedders into both packages' tables: the same tables,
  scores and ingested marks, the rows within 1e-5 (the encoders' f32
  reassociation); a second pass adds nothing; a re-weighted panel learns
  through the archived panel's ``training_table_id``; a panel with new
  tables still learns from history other tables ingested; one embed call
  per pass; a failing ``add_rows`` marks nothing.
"""

import numpy as np
import pytest

from llm_weighted_consensus_tpu import archive as ref_archive
from llm_weighted_consensus_tpu.identity.model import ModelBase as RefModel
from llm_weighted_consensus_tpu.weights import learning as ref_learning
from llm_weighted_consensus_tpu.weights.training_table import (
    TrainingTableStore as RefTables,
)
from llm_weighted_consensus_tpu_torch import archive as port_archive
from llm_weighted_consensus_tpu_torch.identity.model import ModelBase
from llm_weighted_consensus_tpu_torch.weights import learning
from llm_weighted_consensus_tpu_torch.weights.training_table import (
    TrainingTableStore,
)

from test_torch_score import (
    KEYS2,
    PKGS,
    _fake_tt,
    go,
    judge_script,
    make_client,
)
from test_torch_training_table import PROMPTS, micro_embedders

ROW_TOL = 1e-5


def tt_panel(base_weight=1, max_tokens=32):
    return {
        "llms": [{"model": m, "weight": {
            "type": "training_table", "base_weight": base_weight,
            "min_weight": 1, "max_weight": 5}} for m in ("judge-a",
                                                          "judge-b")],
        "weight": {"type": "training_table",
                   "embeddings": {"model": "bge-micro",
                                  "max_tokens": max_tokens},
                   "top": 3},
    }


def build_archive(pkg: str):
    """``pkg``'s archive of one training-table completion per prompt
    (judges agreeing or not, by prompt) and one static-weight one."""
    p = PKGS[pkg]
    store = (ref_archive if pkg == "ref" else port_archive).InMemoryArchive()
    order = [llm.base.model for llm in RefModel.from_json_obj(
        tt_panel()).into_model_validate().llms]
    bodies = []
    for k, prompt in enumerate(PROMPTS):
        by_model = {"judge-a": judge_script(KEYS2[k % 2]),
                    "judge-b": judge_script(KEYS2[(k // 2) % 2],
                                            delay=0.01)}
        bodies.append(({"messages": [{"role": "user", "content": prompt}],
                        "model": tt_panel(), "choices": ["yes", "no"]},
                       [by_model[m] for m in order]))
    bodies.append(({"messages": [{"role": "user", "content": "static"}],
                    "model": {"llms": [{"model": "judge-a"}]},
                    "choices": ["yes", "no"]}, [judge_script(KEYS2[0])]))
    for b, scripts in bodies:
        client, _ = make_client(pkg, scripts, weight_fetchers=_fake_tt,
                                ballot_sink=store.put_ballot)
        params = p.req.ChatCompletionCreateParams.from_json_obj(b)
        result = go(client.create_unary(None, params))
        store.put_score(result)
        store.put_score_request(result.id, params)
    return store


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """(the JAX archive, the port's load of its snapshot)."""
    ref = build_archive("ref")
    path = str(tmp_path_factory.mktemp("learn") / "archive.json")
    ref.save(path)
    return ref, port_archive.InMemoryArchive.load(path)


@pytest.fixture(scope="module")
def micro():
    return micro_embedders()


class CountingEmbedder:
    def __init__(self, inner):
        self.inner = inner
        self.calls = []

    def embed_texts(self, texts, max_tokens=None):
        self.calls.append((list(texts), max_tokens))
        return self.inner.embed_texts(texts, max_tokens=max_tokens)


@pytest.mark.parametrize("label", [None, 0, 1, -1, 9])
def test_judge_alignment_scores_are_the_reference_scores(stores, label):
    ref, port = stores
    for cid in ref.score_ids():
        want = ref_learning.judge_alignment_scores(
            ref.score_completion(cid), label)
        got = learning.judge_alignment_scores(port.score_completion(cid),
                                              label)
        assert got == want
        assert all(0.0 <= s <= 1.0 for s in got.values())


def _populate_both(stores, micro, panel, **kw):
    ref, port = stores
    ref_emb, port_emb = micro
    ref_tables, port_tables = RefTables(), TrainingTableStore()
    counted = CountingEmbedder(port_emb)
    n_ref = ref_learning.populate_from_archive(
        ref, ref_emb, RefModel.from_json_obj(panel).into_model_validate(),
        ref_tables, **kw)
    n_port = learning.populate_from_archive(
        port, counted, ModelBase.from_json_obj(panel).into_model_validate(),
        port_tables, **kw)
    return n_ref, n_port, ref_tables, port_tables, counted


def _same_tables(ref_tables, port_tables):
    assert sorted(port_tables._tables) == sorted(ref_tables._tables)
    assert port_tables._ingested == ref_tables._ingested
    for tid, (emb, scores) in ref_tables._tables.items():
        got_emb, got_scores = port_tables.get(tid)
        assert got_emb.dtype == np.float32 and got_emb.shape == emb.shape
        assert np.max(np.abs(got_emb - emb)) <= ROW_TOL
        assert np.array_equal(got_scores, scores)


@pytest.mark.parametrize("labelled", [False, True])
def test_populate_from_archive_matches_jax(stores, micro, labelled):
    ref, _ = stores
    labels = ({cid: i % 2 for i, cid in enumerate(ref.score_ids())}
              if labelled else None)
    n_ref, n_port, ref_tables, port_tables, counted = _populate_both(
        stores, micro, tt_panel(), labels=labels)
    # every training-table completion gives one row per judge's table
    assert n_port == n_ref == 2 * len(PROMPTS)
    _same_tables(ref_tables, port_tables)
    # one embed call for the pass, at the panel's max_tokens
    [(texts, max_tokens)] = counted.calls
    assert len(texts) == len(PROMPTS) and max_tokens == 32
    assert texts[0] == f"user: {PROMPTS[0]}"
    # the learned rows are the prompts' embeddings
    tid = sorted(port_tables._tables)[0]
    want = micro[1].embed_texts(texts, max_tokens=32)
    assert np.max(np.abs(port_tables.get(tid)[0] - want)) <= ROW_TOL


def test_a_second_pass_adds_nothing(stores, micro):
    ref, port = stores
    _, _, ref_tables, port_tables, counted = _populate_both(
        stores, micro, tt_panel())
    model = ModelBase.from_json_obj(tt_panel()).into_model_validate()
    again = learning.populate_from_archive(port, counted, model, port_tables)
    assert again == 0 and len(counted.calls) == 1
    assert ref_learning.populate_from_archive(
        ref, micro[0], RefModel.from_json_obj(tt_panel()).into_model_validate(),
        ref_tables) == 0
    _same_tables(ref_tables, port_tables)


def test_a_reweighted_panel_learns_through_the_archived_table_ids(
        stores, micro):
    n_ref, n_port, ref_tables, port_tables, _ = _populate_both(
        stores, micro, tt_panel(base_weight=2))
    assert n_port == n_ref == 2 * len(PROMPTS)
    _same_tables(ref_tables, port_tables)
    want_ids = {llm.training_table_id for llm in ModelBase.from_json_obj(
        tt_panel()).into_model_validate().llms}
    assert set(port_tables._tables) == want_ids


def test_idempotence_is_per_table_and_ids_dedupe(stores, micro):
    ref, port = stores
    ids = ref.score_ids()[:3] + ref.score_ids()[:2]
    n_ref, n_port, ref_tables, port_tables, counted = _populate_both(
        stores, micro, tt_panel(), ids=ids)
    assert n_port == n_ref == 2 * 3
    _same_tables(ref_tables, port_tables)
    # another table store (new tables) still learns the same history
    other = TrainingTableStore()
    model = ModelBase.from_json_obj(tt_panel()).into_model_validate()
    assert learning.populate_from_archive(port, micro[1], model, other,
                                          ids=ids) == 6


def test_a_failing_add_rows_marks_nothing(stores, micro):
    _, port = stores

    class Refusing(TrainingTableStore):
        def add_rows(self, table_id, embeddings, scores):
            raise ValueError("embedding width changed")

    tables = Refusing()
    model = ModelBase.from_json_obj(tt_panel()).into_model_validate()
    with pytest.raises(ValueError):
        learning.populate_from_archive(port, micro[1], model, tables)
    assert tables._ingested == set()


def test_completions_without_a_request_are_skipped(micro):
    store = build_archive("port")
    for cid in store.score_ids():
        store._score_requests.pop(cid)
    model = ModelBase.from_json_obj(tt_panel()).into_model_validate()
    counted = CountingEmbedder(micro[1])
    assert learning.populate_from_archive(
        store, counted, model, TrainingTableStore()) == 0
    assert counted.calls == []
