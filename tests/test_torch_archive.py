"""The port's archive write side and re-scoring against the JAX package's.

* ``InMemoryArchive``'s FIFO cap, score requests and ballots (the orphan
  queue, its cap ``MAX_BALLOT_COMPLETIONS``, the rotation rule): the
  cases of ``tests/test_archive_cap.py`` and seeded churn, replayed as
  the same operation sequence on both packages' archives, with every
  table, the orphan queue and its counters equal after each case;
* snapshots: an archive the JAX package saved loads in the port and saves
  to the same bytes, and the other way round;
* ``archive/rescore.py``: ``vote_matrix`` and ``revote_inputs`` equal the
  reference's arrays exactly, and ``rescore_archive`` (plain, ``revote``,
  ``weight_overrides``, ``ids``) and ``apply_rescore`` agree within 1e-6
  (the f32 tally sums in another order on each side: values, not bytes);
  ``revote`` re-extracts each soft vote within 1e-6 of the stored exact
  Decimal one;
* the score client's ``ballot_sink`` records the reference's ballots.

The archives hold real score completions: the cases of
``tests/test_torch_score.py`` through each package's ``ScoreClient`` on
the same scripted judges and seeded ballots.
"""

import random
from types import SimpleNamespace

import numpy as np
import pytest

from llm_weighted_consensus_tpu import archive as ref_archive
from llm_weighted_consensus_tpu.archive import rescore as ref_rescore
from llm_weighted_consensus_tpu.types import chat_response as ref_chat_resp
from llm_weighted_consensus_tpu.types import multichat_response as ref_mc
from llm_weighted_consensus_tpu_torch import archive as port_archive
from llm_weighted_consensus_tpu_torch.archive import rescore as port_rescore
from llm_weighted_consensus_tpu_torch.types import chat_response as port_chat_resp
from llm_weighted_consensus_tpu_torch.types import multichat_response as port_mc

from test_torch_score import ARCHIVED, CASES, PKGS, go, make_client

TOL = 1e-6
ARCHIVES = {"ref": ref_archive, "port": port_archive}


# -- the cap and the ballots ----------------------------------------------------


def comp(cid: str) -> SimpleNamespace:
    return SimpleNamespace(id=cid)


def state(store) -> dict:
    return {
        "chat": store.chat_ids(), "score": store.score_ids(),
        "multichat": store.multichat_ids(),
        "ballots": {c: {j: list(map(list, p)) for j, p in b.items()}
                    for c, b in store._ballots.items()},
        "requests": list(store._score_requests),
        "orphans": list(store._ballot_orphans),
        "orphan_maxlen": store._ballot_orphans.maxlen,
        "n_orphans": store._n_orphan_ballots,
        "drops": store._orphan_queue_drops,
    }


def fifo(s):
    for cid in "abcde":
        s.put_chat(comp(cid))


def reinsert(s):
    for cid in "aba":
        s.put_score(comp(cid))


def cap_zero(s):
    s.put_chat(comp("a"))
    s.put_score(comp("b"))
    s.put_multichat(comp("c"))


def unbounded(s):
    for i in range(100):
        s.put_chat(comp(f"c{i}"))


def score_eviction(s):
    s.put_score(comp("old"))
    s.put_ballot("old", 0, [("k", 1)])
    s.put_score_request("old", SimpleNamespace(messages=[]))
    s.put_score(comp("new"))


def chat_eviction(s):
    s.put_score(comp("x"))
    s.put_ballot("x", 0, [("k", 0)])
    s.put_chat(comp("x"))
    s.put_chat(comp("y"))


def enforce_cap(s):
    for cid in ("c1", "c2", "c3"):
        s.put_chat(comp(cid))
    for cid in ("s1", "s2", "s3"):
        s.put_score(comp(cid))
        s.put_ballot(cid, 0, [("k", 2)])
    for cid in ("m1", "m2", "m3"):
        s.put_multichat(comp(cid))
    s.max_completions = 1
    s.enforce_cap()


def enforce_noop(s):
    s.put_chat(comp("a"))
    s.enforce_cap()


def churn(s):
    for i in range(32):
        cid = f"s{i}"
        s.put_score(comp(cid))
        s.put_ballot(cid, 0, [("k", i)])
        s.put_score_request(cid, SimpleNamespace(messages=[]))


def orphan_queue_bounded(s):
    for i in range(s._ballot_orphans.maxlen + 500):
        cid = f"s{i}"
        s.put_ballot(cid, 0, [("k", i)])
        s.put_score(comp(cid))


def _shrink(s, cap):
    from collections import deque

    s.MAX_BALLOT_COMPLETIONS = cap
    s._ballot_orphans = deque(maxlen=2 * cap)


def displacement(s):
    _shrink(s, 4)
    for i in range(4):
        s.put_ballot(f"o{i}", 0, [("k", i)])
    for i in range(4):
        s.put_score(comp(f"a{i}"))
        s.put_ballot(f"a{i}", 0, [("k", i)])
    s.put_ballot("one-more", 0, [("k", 99)])


def late_ballot_rotation(s):
    """A late ballot for the oldest orphan while the queue is over its
    cap: the in-flight id rotates to the back instead of wedging it."""
    _shrink(s, 3)
    for i in range(5):
        s.put_ballot(f"o{i}", 0, [("k", i)])
    s.put_ballot("o4", 1, [("k", 9)])
    s.put_ballot("o0", 2, [("k", 7)])
    s.put_score(comp("o3"))
    s.put_ballot("o9", 0, [("k", 1)])


def streaming_churn(seed):
    """Seeded streamed traffic: a request's ballots arrive judge by judge
    before its fold archives it (or never, when the stream is
    abandoned), interleaved with other requests, under small caps."""

    def run(s):
        _shrink(s, 6)
        s.max_completions = 10
        rng = random.Random(seed)
        live = []
        for step in range(400):
            roll = rng.random()
            if roll < 0.3 or not live:
                live.append(f"r{step}")
            cid = rng.choice(live)
            if roll < 0.75:
                s.put_ballot(cid, rng.randrange(4), [("k", step)])
            elif roll < 0.92:
                s.put_score(comp(cid))
                s.put_score_request(cid, SimpleNamespace(messages=[]))
                live.remove(cid)
            else:
                live.remove(cid)  # abandoned: its ballots stay orphans
    return run


CAP_CASES = {
    "fifo_eviction_order": (3, fifo),
    "reinserting_existing_id": (2, reinsert),
    "cap_zero_holds_nothing": (0, cap_zero),
    "negative_cap_treated_as_zero": (-5, cap_zero),
    "unbounded_when_cap_is_none": (None, unbounded),
    "score_eviction_drops_ballots_and_request": (1, score_eviction),
    "chat_eviction_leaves_score_tables_alone": (1, chat_eviction),
    "enforce_cap_applies_to_all_tables": (None, enforce_cap),
    "enforce_cap_noop_when_unbounded": (None, enforce_noop),
    "tables_consistent_under_churn": (4, churn),
    "orphan_queue_structure_is_bounded": (None, orphan_queue_bounded),
    "orphan_queue_displacement_evicts_live_head": (None, displacement),
    "late_ballot_rotates_past_the_cap": (None, late_ballot_rotation),
    **{f"streaming_churn_{seed}": (None, streaming_churn(seed))
       for seed in range(4)},
}


@pytest.mark.parametrize("case", sorted(CAP_CASES))
def test_cap_and_ballot_cases_replay_alike(case):
    cap, ops = CAP_CASES[case]
    states = {}
    for pkg, mod in ARCHIVES.items():
        store = mod.InMemoryArchive(max_completions=cap)
        ops(store)
        states[pkg] = state(store)
        orphans = [c for c in store._ballots if c not in store._score]
        assert store._n_orphan_ballots == len(orphans)
    assert states["port"] == states["ref"]


def test_service_cap_default_and_unbounded():
    assert port_archive.InMemoryArchive().max_completions is None
    assert port_archive.InMemoryArchive.MAX_BALLOT_COMPLETIONS == \
        ref_archive.InMemoryArchive.MAX_BALLOT_COMPLETIONS


# -- real score completions --------------------------------------------------------

SCORE_CASES = ["agreement", "disagreement", "judge_failure", "soft_vote",
               "soft_vote_wide", "many_judges", "json_schema", "usage"]


def build_archive(pkg: str):
    """``pkg``'s archive of one unary score completion per case of
    ``SCORE_CASES`` (with its request and ballots), a chat completion and
    a multichat completion."""
    p = PKGS[pkg]
    store = ARCHIVES[pkg].InMemoryArchive()
    for name in SCORE_CASES:
        b, scripts = CASES[name]
        client, _ = make_client(pkg, scripts, ballot_sink=store.put_ballot)
        params = p.req.ChatCompletionCreateParams.from_json_obj(b)
        result = go(client.create_unary(None, params))
        store.put_score(result)
        store.put_score_request(result.id, params)
    chat = (ref_chat_resp if pkg == "ref" else port_chat_resp)
    store.put_chat(chat.ChatCompletion.from_json_obj(ARCHIVED))
    mc = (ref_mc if pkg == "ref" else port_mc)
    store.put_multichat(mc.ChatCompletion.from_json_obj({
        "id": "mcc-1", "created": 3, "model": "panel", "object":
        "chat.completion", "choices": [{
            "index": 0, "finish_reason": "stop", "model": "gen-a",
            "model_index": 0, "message": {"role": "assistant",
                                          "content": "forty two"}}]}))
    return store


@pytest.fixture(scope="module")
def jax_archive():
    return build_archive("ref")


@pytest.fixture(scope="module")
def crossed(jax_archive, tmp_path_factory):
    """(JAX archive, the port's load of its snapshot)."""
    path = str(tmp_path_factory.mktemp("archive") / "ref.json")
    jax_archive.save(path)
    return jax_archive, port_archive.InMemoryArchive.load(path)


def test_snapshot_from_jax_loads_in_the_port_with_the_same_bytes(
        jax_archive, tmp_path):
    path, again = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
    jax_archive.save(path)
    loaded = port_archive.InMemoryArchive.load(path)
    assert loaded.score_ids() == jax_archive.score_ids()
    assert loaded.chat_ids() == ["cc-old"]
    assert loaded.multichat_ids() == ["mcc-1"]
    loaded.save(again)
    with open(path, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()


def test_snapshot_from_the_port_loads_in_jax_with_the_same_bytes(tmp_path):
    store = build_archive("port")
    path, again = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    store.save(path)
    loaded = ref_archive.InMemoryArchive.load(path)
    assert loaded.score_ids() == store.score_ids()
    assert len(loaded.score_ids()) == len(SCORE_CASES)
    for cid in store.score_ids():
        assert loaded.score_ballots(cid) == {
            j: [list(p) for p in pairs]
            for j, pairs in store.score_ballots(cid).items()}
        assert loaded.score_request(cid).to_json_obj() == \
            store.score_request(cid).to_json_obj()
    loaded.save(again)
    with open(path, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()


def test_snapshot_of_an_unknown_version_is_refused(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text('{"version": 99}')
    with pytest.raises(ValueError, match="version 99"):
        port_archive.InMemoryArchive.load(str(path))


def test_ballot_sink_records_the_reference_ballots(crossed):
    ref, _ = crossed
    port = build_archive("port")
    for rid, pid in zip(ref.score_ids(), port.score_ids()):
        assert {j: [list(p) for p in pairs]
                for j, pairs in port.score_ballots(pid).items()} == \
            {j: [list(p) for p in pairs]
             for j, pairs in ref.score_ballots(rid).items()}


@pytest.mark.parametrize("case", SCORE_CASES)
def test_vote_matrix_and_revote_inputs_equal_jax(crossed, case):
    ref, port = crossed
    cid = ref.score_ids()[SCORE_CASES.index(case)]
    want = ref_rescore.vote_matrix(ref.score_completion(cid))
    got = port_rescore.vote_matrix(port.score_completion(cid))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    m, n = want[0].shape
    want = ref_rescore.revote_inputs(
        ref.score_completion(cid), ref.score_ballots(cid), m, n)
    got = port_rescore.revote_inputs(
        port.score_completion(cid), port.score_ballots(cid), m, n)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if case.startswith("soft_vote"):
        assert got[3].all()  # every judge re-extracts from its logprobs


def _results_close(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    worst = 0.0
    for cid in want:
        for field in ("weight", "confidence"):
            a = np.array([float(x) for x in got[cid][field]])
            b = np.array([float(x) for x in want[cid][field]])
            assert a.shape == b.shape and np.isfinite(a).all()
            worst = max(worst, float(np.max(np.abs(a - b), initial=0.0)))
    return worst


def _judge_ids(store):
    return sorted({c.model for cid in store.score_ids()
                   for c in store.score_completion(cid).choices
                   if c.model_index is not None})


RESCORE_MODES = {
    "plain": lambda s: {},
    "revote": lambda s: {"revote": True},
    "overrides": lambda s: {"weight_overrides": {_judge_ids(s)[0]: 3.0,
                                                 _judge_ids(s)[-1]: 0.25}},
    "revote_overrides": lambda s: {"revote": True, "weight_overrides": {
        _judge_ids(s)[1]: 7.0}},
    "ids": lambda s: {"ids": s.score_ids()[1:4]},
}


@pytest.mark.parametrize("mode", sorted(RESCORE_MODES))
def test_rescore_archive_matches_jax(crossed, mode):
    ref, port = crossed
    kw = RESCORE_MODES[mode](ref)
    want = ref_rescore.rescore_archive(ref, **kw)
    got = port_rescore.rescore_archive(port, device="cpu", **kw)
    assert _results_close(got, want) <= TOL
    for scores in got.values():
        conf = [float(c) for c in scores["confidence"]]
        assert sum(conf) == pytest.approx(1.0, abs=TOL) or sum(conf) == 0.0


def test_revote_reextracts_the_stored_votes(crossed):
    """``revote`` over the stored logprobs gives each judge's stored
    (exact Decimal) vote again, within 1e-6: the re-scored confidences of
    a one-judge soft-vote completion are that judge's vote."""
    _, port = crossed
    cid = port.score_ids()[SCORE_CASES.index("soft_vote")]
    completion = port.score_completion(cid)
    [judge] = [c for c in completion.choices if c.model_index is not None]
    stored = [float(v) for v in judge.message.vote]
    got = port_rescore.rescore_archive(port, ids=[cid], revote=True,
                                       device="cpu")[cid]
    assert np.max(np.abs(np.array([float(c) for c in got["confidence"]])
                         - stored)) <= TOL


def test_apply_rescore_matches_jax(jax_archive, tmp_path):
    path = str(tmp_path / "a.json")
    jax_archive.save(path)
    ref = ref_archive.InMemoryArchive.load(path)
    port = port_archive.InMemoryArchive.load(path)
    kw = {"weight_overrides": {_judge_ids(ref)[0]: 5.0}, "revote": True}
    n_ref = ref_rescore.apply_rescore(
        ref, ref_rescore.rescore_archive(ref, **kw))
    results = port_rescore.rescore_archive(port, device="cpu", **kw)
    n_port = port_rescore.apply_rescore(port, results)
    assert n_port == n_ref == len(SCORE_CASES)
    assert port_rescore.apply_rescore(port, {"nope": results[
        port.score_ids()[0]]}) == 0
    for cid in ref.score_ids():
        for a, b in zip(port.score_completion(cid).choices,
                        ref.score_completion(cid).choices):
            assert a.model_index == b.model_index
            if a.model_index is None:
                assert abs(float(a.weight) - float(b.weight)) <= TOL
                assert abs(float(a.confidence) - float(b.confidence)) <= TOL
                # written back as the Decimal of the f32 result
                assert a.confidence == results[cid]["confidence"][a.index]
