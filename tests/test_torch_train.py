"""The port's offline lane and weight learner against the reference's
(``tests/test_train.py``'s counterparts): the ledger feed over rotated
shards, ``synthetic_groups``, the dataset and accuracy arrays, the
batched fit against the reference's optax fit, the miscalibrated-judge
drill through the port's ``ScoreClient`` and ``JUDGE_BIAS_PLAN`` by the
API and by the CLI, the hot-swap drill over the port's gateway with
``GET``/``PUT /v1/weights`` and their 403s byte-equal to the reference
gateway's, and ``/v1/train/rescore`` on a bge_micro CPU server.

Tolerance of the fitted weights against the reference's: 1e-5 absolute
(both mean-normalized to 1; measured 1.2e-7 on these records in f32 on
the CPU: the two Adams differ only in where the bias corrections round).
"""

import asyncio
import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from llm_weighted_consensus_tpu import obs as ref_obs
from llm_weighted_consensus_tpu import resilience as ref_res
from llm_weighted_consensus_tpu.obs import ledger as ref_ledger_mod
from llm_weighted_consensus_tpu.train import feed as ref_feed
from llm_weighted_consensus_tpu.train import fit as ref_fit
from llm_weighted_consensus_tpu.weights import live as ref_live
from llm_weighted_consensus_tpu_torch import obs as port_obs
from llm_weighted_consensus_tpu_torch import resilience as port_res
from llm_weighted_consensus_tpu_torch.obs.ledger import (
    ledger_shard_paths,
    load_ledger_records,
)
from llm_weighted_consensus_tpu_torch.serve.batcher import DeviceBatcher
from llm_weighted_consensus_tpu_torch.serve.gateway import Server
from llm_weighted_consensus_tpu_torch.serve.metrics import Metrics
from llm_weighted_consensus_tpu_torch.train import feed, fit
from llm_weighted_consensus_tpu_torch.weights import live

from test_torch_batcher import micro  # noqa: F401  (the bge_micro fixture)
from test_torch_score import (
    PKGS,
    ballot_keys,
    go,
    judge_script,
    make_client,
)
from test_torch_traced_serve import port_calls, ref_calls

FIT_ATOL = 1e-5
TEXTS = ["answer alpha", "answer beta"]


@pytest.fixture(autouse=True)
def _fresh_quality():
    for obs in (ref_obs, port_obs):
        obs.reset_quality()
    yield
    for obs in (ref_obs, port_obs):
        obs.reset_quality()


def _synthetic_records(n=24, flip_after=8):
    """A miscalibrated panel: judge-c carries weight 3 but votes for the
    wrong candidate after ``flip_after``; a and b (weight 1) stay
    honest.  The recorded winner follows the (wrong) weighted tally."""
    records = []
    for i in range(n):
        flipped = i >= flip_after
        c_vote = [0.0, 1.0] if flipped else [1.0, 0.0]
        records.append({
            "id": f"rec-{i}",
            "n_choices": 2,
            "all_failed": False,
            "winner": 1 if flipped else 0,
            "judges": [
                {"model": "judge-a", "vote": [1.0, 0.0], "weight": 1.0},
                {"model": "judge-b", "vote": [1.0, 0.0], "weight": 1.0},
                {"model": "judge-c", "vote": c_vote, "weight": 3.0},
            ],
        })
    return records


# -- the feed -------------------------------------------------------------------


@pytest.mark.parametrize("seed,groups,n", [(0, 3, 4), (7, 5, 8), (123, 2, 2)])
def test_synthetic_groups_are_the_references(seed, groups, n):
    got = feed.synthetic_groups(groups, n, seed=seed)
    assert got == ref_feed.synthetic_groups(groups, n, seed=seed)
    assert len({t for g in got for t in g}) == groups * n


def test_the_ledger_feed_streams_rotated_shards_with_torn_tails(tmp_path):
    ledger = port_obs.OutcomeLedger(capacity=2, disk_dir=str(tmp_path),
                                    rotate_bytes=150)
    for i in range(8):
        ledger.offer({"id": f"r{i}", "payload": "z" * 48})
    paths = ledger_shard_paths(str(tmp_path))
    assert len(paths) >= 3
    # a crash mid-append tears a sealed shard's tail and the active one's
    with open(paths[0], "a", encoding="utf-8") as f:
        f.write('{"id": "torn-a"')
    with open(paths[-1], "a", encoding="utf-8") as f:
        f.write('{"id": "torn-b", "partial": tru')
    port, ref = feed.LedgerFeed(str(tmp_path)), ref_feed.LedgerFeed(
        str(tmp_path))
    ids = [r["id"] for r in port.records()]
    assert ids == [r["id"] for r in ref.records()]
    assert ids == [f"r{i}" for i in range(8)]
    assert (port.shards_read, port.torn) == (ref.shards_read, ref.torn) \
        == (len(paths), 2)


def _completion(*choices):
    return SimpleNamespace(choices=[
        SimpleNamespace(index=i, model_index=mi,
                message=SimpleNamespace(content=c, vote=None))
        for i, c, mi in choices
    ])


def test_candidate_texts_and_archive_groups_are_the_references():
    done = _completion((1, "beta", None), (0, "alpha", None),
                       (2, "judge says", 0), (3, "", None), (4, None, None))
    assert feed.candidate_texts(done) == ref_feed.candidate_texts(done) \
        == ["alpha", "beta"]
    store = SimpleNamespace(
        score_ids=lambda: ["ok", "solo", "gone"],
        score_completion=lambda cid: {
            "ok": _completion((0, "a", None), (1, "b", None)),
            "solo": _completion((0, "only", None)),
        }.get(cid),
    )
    assert list(feed.archive_groups(store)) == list(
        ref_feed.archive_groups(store)) == [["a", "b"]]


# -- the dataset and the fit ---------------------------------------------------------


def _extra_records():
    records = _synthetic_records(4, flip_after=99)
    judges = records[0]["judges"]
    records += [
        {"id": "failed", "n_choices": 2, "all_failed": True, "winner": 0,
         "judges": judges},
        {"id": "solo", "n_choices": 1, "winner": 0, "judges": judges},
        {"id": "mute", "n_choices": 2, "winner": 0, "judges": []},
        {"id": "unlabeled", "n_choices": 2, "judges": judges},
        {"id": "ragged", "n_choices": 3, "winner": 2, "label": 1,
         "judges": [{"model": "judge-d", "vote": [0.2, 0.5, 0.3],
                     "weight": 2.5},
                    {"model": "judge-a", "vote": [1.0, 0.0, 0.0]}]},
    ]
    return records


@pytest.mark.parametrize("labels", [None, {"rec-0": 1, "ragged": 0}])
def test_build_dataset_and_tally_accuracy_arrays_are_the_references(labels):
    got = fit.build_dataset(_extra_records(), labels)
    want = ref_fit.build_dataset(_extra_records(), labels)
    for name in ("votes", "vote_mask", "cand_mask", "labels",
                 "sample_weight", "base_weights"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.judge_ids, got.skipped, got.n_records) == (
        want.judge_ids, want.skipped, want.n_records) == (
        ["judge-a", "judge-b", "judge-c", "judge-d"], 4, 5)
    for w in (got.base_weights, np.ones(4, np.float32),
              np.array([0.1, 2.0, 0.5, 3.0], np.float32)):
        assert fit.tally_accuracy(got, w) == ref_fit.tally_accuracy(want, w)
    train, hold = fit.holdout_split(got, every=2)
    rtrain, rhold = ref_fit.holdout_split(want, every=2)
    np.testing.assert_array_equal(hold.labels, rhold.labels)
    assert (train.n_records, hold.n_records) == (rtrain.n_records,
                                                 rhold.n_records)
    assert fit.build_dataset([]) is None


@pytest.mark.parametrize("flip_after,steps", [(8, 200), (5, 300), (0, 50)])
def test_fit_weights_matches_the_reference_fit(flip_after, steps):
    labels = {f"rec-{i}": 0 for i in range(24)}
    records = _synthetic_records(24, flip_after=flip_after)
    got = fit.fit_weights(fit.build_dataset(records, labels), steps=steps,
                          device="cpu")
    want = ref_fit.fit_weights(ref_fit.build_dataset(records, labels),
                               steps=steps)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=FIT_ATOL)


def test_the_fit_downweights_the_miscalibrated_judge():
    labels = {f"rec-{i}": 0 for i in range(24)}
    report = fit.fit_from_records(_synthetic_records(24, flip_after=8),
                                  labels=labels, steps=200, device="cpu")
    want = ref_fit.fit_from_records(_synthetic_records(24, flip_after=8),
                                    labels=labels, steps=200)
    assert report["records"] == 24 and report["version"].startswith("wv-")
    assert report["accuracy"] == want["accuracy"]
    assert report["accuracy"]["fitted"] > report["accuracy"]["base"]
    assert report["accuracy"]["fitted"] == 1.0
    weights = report["weights"]
    assert weights["judge-c"] < weights["judge-a"] and weights["judge-c"] < 0.5
    for jid, w in weights.items():
        assert abs(w - want["weights"][jid]) <= FIT_ATOL
    masked = {k: v for k, v in report.items() if k not in ("version",
                                                           "weights")}
    assert masked == {k: v for k, v in want.items()
                      if k not in ("version", "weights")}


# -- the fit and the trainers on a mesh --------------------------------------------


def _jax_mesh(dp, tp=1):
    from llm_weighted_consensus_tpu.parallel.mesh import make_mesh

    return make_mesh(dp=dp, tp=tp)


def _port_mesh(dp, tp=1):
    import torch

    from llm_weighted_consensus_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(dp=dp, tp=tp, devices=[torch.device("cpu")] * (dp * tp))


@pytest.mark.parametrize("records,dp", [(24, 4), (23, 4), (21, 8), (9, 2)],
                         ids=["24-dp4", "ragged-23-dp4", "ragged-21-dp8",
                              "ragged-9-dp2"])
def test_fit_weights_on_a_mesh_matches_the_reference_mesh_fit(records, dp):
    """The records dp-sharded (a ragged tail padded with zero-weight
    rows), theta replicated: the reference's mesh fit within 1e-5, and
    the port's own one-device fit."""
    labels = {f"rec-{i}": 0 for i in range(records)}
    rec = _synthetic_records(records, flip_after=5)
    dataset = fit.build_dataset(rec, labels)
    got = fit.fit_weights(dataset, steps=120, mesh=_port_mesh(dp))
    want = ref_fit.fit_weights(ref_fit.build_dataset(rec, labels), steps=120,
                               mesh=_jax_mesh(dp))
    one = fit.fit_weights(dataset, steps=120, device="cpu")
    np.testing.assert_allclose(got, want, atol=FIT_ATOL)
    np.testing.assert_allclose(got, one, atol=FIT_ATOL)
    _, losses = fit.fit_losses(dataset, steps=5, mesh=_port_mesh(dp))
    _, one_losses = fit.fit_losses(dataset, steps=5, device="cpu")
    np.testing.assert_allclose(losses, one_losses, rtol=1e-6)


def _jax_step_on_mesh(step, params, config, batch, lr, dp, tp, shard):
    import jax
    import jax.numpy as jnp

    from llm_weighted_consensus_tpu import train as jtrain
    from llm_weighted_consensus_tpu.parallel import sharding as jsharding

    mesh = _jax_mesh(dp, tp)
    params = shard(params, mesh)
    optimizer = jtrain.make_optimizer(lr=lr)
    opt_state = optimizer.init(params)
    b_shard = jsharding.batch_sharding(mesh)
    args = [jax.device_put(jnp.asarray(a), b_shard) for a in batch]
    params, _, loss = step(params, opt_state, *args, config, optimizer)
    return jax.tree_util.tree_map(np.asarray, params), float(loss)


def _check_step(model, before, loss, want_state, want_loss, one_loss=None):
    """The loss at 1e-4 relative; every parameter after the step within
    1e-4 of the model's largest parameter magnitude of the reference's;
    and the update itself (after - before) the reference's update within
    1e-3 of its norm, so a step that moved nothing fails."""
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-4)
    if one_loss is not None:
        np.testing.assert_allclose(float(loss), float(one_loss), rtol=1e-4)
    after = {k: v.detach().numpy() for k, v in model.named_parameters()}
    assert set(after) == set(want_state)
    scale = max(float(np.abs(v).max()) for v in want_state.values())
    num = den = 0.0
    for name, got in after.items():
        np.testing.assert_allclose(got, want_state[name], rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
        d_got = got - before[name]
        d_want = want_state[name] - before[name]
        num += float(np.sum((d_got - d_want) ** 2))
        den += float(np.sum(d_want ** 2))
        if float(np.abs(d_want).max()) > 0:
            assert float(np.abs(d_got).max()) > 0, f"{name} did not move"
    assert den > 0 and (num / den) ** 0.5 <= 1e-3


@pytest.mark.parametrize("dp,tp", [(2, 2), (4, 1), (1, 2)])
def test_the_infonce_step_on_a_mesh_matches_the_reference(dp, tp):
    """One InfoNCE step over dp x tp: the batch split over dp, the encoder
    Megatron-split over tp, positives gathered across dp before the
    logits (the global batch's negatives), one AdamW step on the master
    parameters.  Held against the reference's step on the same virtual
    mesh and against the port's one-device step."""
    from llm_weighted_consensus_tpu import train as jtrain
    from llm_weighted_consensus_tpu.models import configs as jconfigs
    from llm_weighted_consensus_tpu.parallel import sharding as jsharding
    from llm_weighted_consensus_tpu_torch import train as ptrain
    from llm_weighted_consensus_tpu_torch.models import configs, convert
    from test_torch_trainers import _bert_model, _bert_pair, _pairs

    lr = 1e-3
    params, state = _bert_pair()
    batch = _pairs(jconfigs.TEST_TINY.vocab_size, 4, 16, seed=7)
    want_params, want_loss = _jax_step_on_mesh(
        jtrain.contrastive_train_step, params, jconfigs.TEST_TINY, batch, lr,
        dp, tp, lambda p, m: jsharding.shard_bert_params(p, m, tp=tp > 1))
    want = convert.from_jax_params(want_params, configs.TEST_TINY)
    one = _bert_model(state)
    one_loss = ptrain.contrastive_train_step(
        one, ptrain.make_optimizer(one, lr=lr), *batch)
    model = _bert_model(state)
    before = {k: v.detach().numpy().copy()
              for k, v in model.named_parameters()}
    loss = ptrain.contrastive_train_step(
        model, ptrain.make_optimizer(model, lr=lr), *batch,
        mesh=_port_mesh(dp, tp))
    _check_step(model, before, loss, want, want_loss, one_loss)


@pytest.mark.parametrize("dp,tp", [(2, 2), (2, 1)])
def test_the_bradley_terry_step_on_a_mesh_matches_the_reference(dp, tp):
    from llm_weighted_consensus_tpu import train as jtrain
    from llm_weighted_consensus_tpu.models import configs as jconfigs
    from llm_weighted_consensus_tpu.parallel import sharding as jsharding
    from llm_weighted_consensus_tpu_torch import train as ptrain
    from llm_weighted_consensus_tpu_torch.models import configs, convert
    from test_torch_trainers import _deberta_model, _deberta_pair, _pairs

    lr = 1e-3
    params, state = _deberta_pair()
    batch = _pairs(jconfigs.DEBERTA_TEST_TINY.vocab_size, 4, 24, seed=8)
    want_params, want_loss = _jax_step_on_mesh(
        jtrain.reward_train_step, params, jconfigs.DEBERTA_TEST_TINY, batch,
        lr, dp, tp, lambda p, m: jsharding.shard_by_rules(
            p, m, jsharding.deberta_partition_rules()))
    want = convert.from_jax_deberta_params(want_params,
                                           configs.DEBERTA_TEST_TINY)
    one = _deberta_model(state)
    one_loss = ptrain.reward_train_step(
        one, ptrain.make_optimizer(one, lr=lr), *batch)
    model = _deberta_model(state)
    before = {k: v.detach().numpy().copy()
              for k, v in model.named_parameters()}
    loss = ptrain.reward_train_step(
        model, ptrain.make_optimizer(model, lr=lr), *batch,
        mesh=_port_mesh(dp, tp))
    _check_step(model, before, loss, want, want_loss, one_loss)


def test_a_mesh_step_refuses_a_batch_that_does_not_divide_by_dp():
    from llm_weighted_consensus_tpu.models import configs as jconfigs
    from llm_weighted_consensus_tpu_torch import train as ptrain
    from test_torch_trainers import _bert_model, _bert_pair, _pairs

    model = _bert_model(_bert_pair()[1])
    batch = _pairs(jconfigs.TEST_TINY.vocab_size, 3, 16, seed=7)
    with pytest.raises(ValueError, match="does not divide by dp=2"):
        ptrain.contrastive_train_step(model, ptrain.make_optimizer(model),
                                      *batch, mesh=_port_mesh(2))


def test_a_mesh_step_launches_no_kernel_and_records_its_collectives():
    """The trainers launch no hand-written kernel on a mesh either, and
    the step's collectives are the plan: two tp reductions per layer per
    forward, the positives' all-gather and the loss's psum over dp."""
    from llm_weighted_consensus_tpu.models import configs as jconfigs
    from llm_weighted_consensus_tpu_torch import train as ptrain
    from llm_weighted_consensus_tpu_torch.ops import launches
    from llm_weighted_consensus_tpu_torch.parallel import collectives
    from test_torch_trainers import _bert_model, _bert_pair, _pairs

    model = _bert_model(_bert_pair()[1])
    batch = _pairs(jconfigs.TEST_TINY.vocab_size, 4, 16, seed=7)
    with launches.recording() as noted, collectives.recording() as notes:
        ptrain.contrastive_train_step(model, ptrain.make_optimizer(model),
                                      *batch, mesh=_port_mesh(2, 2))
    assert not noted
    ops = [(n["op"], n["group_size"]) for n in notes]
    layers = jconfigs.TEST_TINY.num_layers
    # per forward (query and positive) and dp row: 2 psums per layer
    assert ops.count(("psum", 2)) == 2 * 2 * 2 * layers + 1
    assert ops.count(("all_gather", 2)) == 1


# -- the learner drill: serve -> rotated ledger shards -> fit ------------------------


PANEL = [
    {"model": "judge-a", "weight": {"type": "static", "weight": 1}},
    {"model": "judge-b", "weight": {"type": "static", "weight": 1}},
    {"model": "judge-c", "weight": {"type": "static", "weight": 3}},
]


def _params(pkg, judges=PANEL):
    return PKGS[pkg].req.ChatCompletionCreateParams.from_json_obj({
        "messages": [{"role": "user", "content": "pick the best"}],
        "model": {"llms": judges}, "choices": TEXTS,
    })


async def _collect(client, params):
    stream = await client.create_streaming(None, params)
    return [item async for item in stream]


def _drill(pkg, obs, res, disk_dir, n_requests=24):
    from llm_weighted_consensus_tpu_torch.identity.model import ModelBase

    keys = ballot_keys(2)
    model = ModelBase.from_json_obj({"llms": PANEL}).into_model_validate()
    biased = next(l for l in model.llms if l.base.model == "judge-c")
    ledger = obs.OutcomeLedger(capacity=64, disk_dir=disk_dir,
                               rotate_bytes=2048)
    client, _ = make_client(
        pkg, [judge_script(keys[0]) for _ in range(3 * n_requests)],
        bias_plan=res.JudgeBiasPlan.parse(
            f"judge={biased.index},after=8,flip=1.0,seed=7"),
        ledger=ledger,
    )
    params = _params(pkg)
    for _ in range(n_requests):
        go(_collect(client, params))
    return ledger, biased


def _masked(record):
    return {k: v for k, v in record.items() if k not in ("id", "created")}


def test_learner_drill_ledger_to_fit_by_the_api_and_the_cli(tmp_path):
    """Records made through the port's tally seam under a seeded
    JUDGE_BIAS_PLAN (judge-c mis-votes with weight 3 after 8 ballots),
    written through shard rotation, streamed back by the feed and fit:
    held-out accuracy beats the observed base weights, through the API
    and through the CLI, as the reference's drill does."""
    n_requests = 24
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    ledger, biased = _drill("port", port_obs, port_res, port_dir)
    ref_ledger, _ = _drill("ref", ref_obs, ref_res, ref_dir)
    # rotation really sharded the drill's ledger, as the reference's
    assert ledger.snapshot()["rotations"] >= 2
    records, torn = load_ledger_records(port_dir)
    ref_records, _ = ref_ledger_mod.load_ledger_records(ref_dir)
    assert len(records) == n_requests and torn == 0
    assert [_masked(r) for r in records] == [_masked(r) for r in ref_records]
    assert all(r["weights_version"] is None for r in records)
    wrong = [r for r in records if r["winner"] == 1]
    assert len(wrong) == n_requests - 8
    labels = {r["id"]: 0 for r in records}

    report = fit.fit_from_ledger(port_dir, labels=labels, steps=200,
                                 device="cpu")
    want = ref_fit.fit_from_ledger(port_dir, labels=labels, steps=200)
    assert report["shards"] == want["shards"] == len(
        ledger_shard_paths(port_dir))
    assert report["records"] == n_requests and report["torn"] == 0
    assert report["accuracy"] == want["accuracy"]
    assert report["accuracy"]["fitted"] > report["accuracy"]["base"]
    assert report["accuracy"]["fitted"] == 1.0
    fitted = report["weights"]
    assert fitted[biased.id] == min(fitted.values())
    for jid, w in fitted.items():
        assert abs(w - want["weights"][jid]) <= FIT_ATOL

    # the CLI: fit --out writes a table WEIGHTS_PATH loads, in either
    # package
    from llm_weighted_consensus_tpu_torch.train.__main__ import main

    labels_path = tmp_path / "labels.json"
    labels_path.write_text(json.dumps(labels))
    out_path = str(tmp_path / "weights.json")
    rc = main(["fit", "--ledger-dir", port_dir, "--labels",
               str(labels_path), "--steps", "200", "--out", out_path,
               "--device", "cpu"])
    assert rc == 0
    assert live.LiveWeightStore(path=out_path).version == report["version"]
    assert ref_live.LiveWeightStore(path=out_path).version == \
        report["version"]
    assert main(["fit", "--ledger-dir", str(tmp_path / "empty"),
                 "--device", "cpu"]) == 1


# -- the hot-swap drill over the gateway ------------------------------------------


def _put(obj, raw=None):
    return ("PUT", "/v1/weights",
            raw if raw is not None else json.dumps(obj).encode(), None)


def _post(path, obj):
    return ("POST", path, json.dumps(obj).encode(), None)


GET = ("GET", "/v1/weights", None, None)


def _swap_calls(dissenter_id):
    score = _post("/score/completions", {
        "messages": [{"role": "user", "content": "q"}],
        "model": {"llms": [{"model": "judge-a"}, {"model": "judge-b"},
                           {"model": "judge-c"}]},
        "choices": TEXTS,
    })
    return (
        [GET] + [score] * 4 + [_put({"weights": {dissenter_id: 5}})]
        + [score] * 4
        + [_put({"weights": {dissenter_id: 1}, "mode": "shadow"})]
        + [score] * 4 + [GET]
        + [_put({"weights": {dissenter_id: -2}}),
           _put({"weights": {dissenter_id: 1}, "mode": "canary"}),
           _put({"not_weights": 1}), _put(None, raw=b"{not json"),
           _put(None, raw=b"[1, 2]"),
           _put({"weights": {dissenter_id: "zebra"}}), GET,
           _put({"weights": {}, "mode": "shadow"}), GET]
    )


def _swap_pair(pkg, obs, live_mod):
    from llm_weighted_consensus_tpu.identity.model import ModelBase

    keys = ballot_keys(2)
    model = ModelBase.from_json_obj({"llms": [
        {"model": m} for m in ("judge-a", "judge-b", "judge-c")
    ]}).into_model_validate()
    dissenter = next(l for l in model.llms if l.base.model == "judge-c")
    # a and b pick candidate 0 every request; c dissents with candidate 1
    scripts = [judge_script(keys[1 if llm is dissenter else 0])
               for _ in range(12) for llm in model.llms]
    ledger = obs.OutcomeLedger(capacity=64)
    store = live_mod.LiveWeightStore()
    client, _ = make_client(pkg, scripts, ledger=ledger, live_weights=store)
    return client, ledger, store, dissenter.id


def test_hot_swap_drill_over_the_gateway_answers_as_the_reference():
    """Versions flip mid-traffic by PUT /v1/weights with zero client
    errors; every ledger record names the version that scored it, the
    swap changes the verdict, the staged shadow table feeds the
    would-have-flipped counters, and every GET and PUT answer is the
    reference gateway's, byte for byte."""
    from llm_weighted_consensus_tpu.clients.multichat import MultichatClient
    from llm_weighted_consensus_tpu.serve import build_app

    client, ref_ledger, ref_store, dissenter = _swap_pair(
        "ref", ref_obs, ref_live)
    app = build_app(client.chat_client, client,
                    MultichatClient(client.chat_client, client.model_fetcher),
                    ledger=ref_ledger, live_weights=ref_store)
    calls = _swap_calls(dissenter)
    want = ref_calls(app, calls)

    client, ledger, store, _ = _swap_pair("port", port_obs, live)
    server = Server(None, chat_client=client.chat_client,
                    score_client=client, ledger=ledger, live_weights=store)
    with server:
        got = port_calls(server, calls)
        snap = json.loads(port_calls(server, [
            ("GET", "/metrics", None, None)])[0][2])
        text = port_calls(server, [
            ("GET", "/metrics?format=prometheus", None, None)])[0][2]
    for (method, path, _, _), (ws, _, wb), (gs, _, gb) in zip(
            calls, want, got):
        assert gs == ws, (method, path, gb)
        if path == "/v1/weights":
            assert gb == wb, (method, gb, wb)
        else:
            assert gs == 200 and "error" not in json.loads(gb)
    version = json.loads(got[5][2])["version"]
    assert version.startswith("wv-")
    wire = json.loads(got[15][2])
    assert (wire["version"], wire["shadow_compared"],
            wire["shadow_would_flip"]) == (version, 4, 4)
    records = ledger.index(limit=12)[::-1]
    assert [r["weights_version"] for r in records] == (
        [live.BASE_VERSION] * 4 + [version] * 8)
    # the swap flipped the served verdict: 2-vs-1 before, 2-vs-5 after
    assert [r["winner"] for r in records] == [0] * 4 + [1] * 8
    assert [_masked(r) for r in records] == [
        _masked(r) for r in ref_ledger.index(limit=12)[::-1]]
    assert snap["weights"]["version"] == version
    assert snap["weights"]["swaps"] == 2
    assert b"lwc_weights_swaps_total 2" in text
    assert b'lwc_weights_shadow_total{kind="would_flip"} 4' in text


def test_the_routes_answer_the_references_403_when_off():
    calls = [GET, _put({"weights": {"j": 1}}), _put(None, raw=b"{}"),
             _post("/v1/train/rescore", {}),
             ("POST", "/v1/train/rescore", b"", None)]
    client, _ = make_client("ref", [])
    from llm_weighted_consensus_tpu.clients.multichat import MultichatClient
    from llm_weighted_consensus_tpu.serve import build_app

    app = build_app(client.chat_client, client,
                    MultichatClient(client.chat_client, client.model_fetcher))
    want = ref_calls(app, calls)
    client, _ = make_client("port", [])
    with Server(None, chat_client=client.chat_client,
                score_client=client) as server:
        got = port_calls(server, calls)
    for (ws, _, wb), (gs, _, gb) in zip(want, got):
        assert (gs, gb) == (ws, wb) and gs == 403


def test_a_put_goes_through_the_body_cap_and_the_tracer():
    client, _ = make_client("port", [])
    store = live.LiveWeightStore()
    sink = port_obs.TraceSink(sample_rate=1.0)
    with Server(None, chat_client=client.chat_client, score_client=client,
                live_weights=store, trace_sink=sink,
                max_body_bytes=256) as server:
        big = _put({"weights": {f"judge-{i}": 1 for i in range(64)}})
        ok = _put({"weights": {"j": 2}})
        (s_big, _, b_big), (s_ok, h_ok, b_ok), (s_404, _, _) = port_calls(
            server, [big, ok, ("PUT", "/v1/other", b"{}", None)])
    assert s_big == 413 and json.loads(b_big)["message"] == {
        "kind": "payload_too_large"}
    assert s_ok == 200 and json.loads(b_ok)["version"] == store.version
    assert s_404 == 404 and store.swaps == 1
    record = sink.get(h_ok["x-trace-id"])
    assert record["spans"][0]["name"] == "gateway:PUT /v1/weights"


# -- the offline lane -------------------------------------------------------------


def test_the_offline_feed_drives_the_port_batcher(micro):
    """The bounded-inflight feed on the threaded batcher: every group
    answered, the lane's counters and occupancy set, the reference's
    answers on the same groups."""
    ref, port = micro
    groups = feed.synthetic_groups(6, 4, seed=3)
    with DeviceBatcher(port, Metrics(), window_ms=1.0) as batcher:
        drive = feed.OfflineFeed(batcher, inflight=3)
        results, occupancy = asyncio.run(drive.drive(groups))
        lanes = batcher.utilization()["lanes"]
    assert (drive.groups, drive.items, drive.errors) == (6, 24, 0)
    assert 0 < occupancy <= 1
    assert lanes["offline"]["items"] == 6 and lanes["latency"]["items"] == 0
    want = [ref.consensus_confidence(g, temperature=0.05) for g in groups]
    for (conf, _tokens), w_conf in zip(results, want):
        np.testing.assert_allclose(np.asarray(conf), np.asarray(w_conf),
                                   atol=1e-5)


def test_latency_items_plan_before_queued_offline_items(micro):
    """Both lanes queued in one window: every latency group dispatches
    before any offline group (pipeline depth 1 orders the dispatches)."""
    _, port = micro
    texts = [f"candidate {i}" for i in range(4)]
    order = []
    lock = threading.Lock()
    with DeviceBatcher(port, None, window_ms=100.0,
                       pipeline_depth=1) as batcher:
        futures = []
        for lane in ("offline", "offline", "latency", "latency"):
            f = batcher.submit_consensus(texts, priority=lane)
            f.add_done_callback(
                lambda _f, lane=lane: (lock.acquire(), order.append(lane),
                                       lock.release()))
            futures.append(f)
        for f in futures:
            f.result(60)
    assert order[:2] == ["latency", "latency"]


def test_a_dispatch_is_counted_before_its_items_are_answered(micro):
    """A caller woken by its answer reads lane counters that include its
    dispatch (the rescore answer's ``lanes``), as on the reference's one
    loop, where ``_observe`` runs before any awaiting coroutine resumes:
    no item of a group is answered when the group is counted."""
    _, port = micro
    answered_early = []
    with DeviceBatcher(port, None, window_ms=1.0) as batcher:
        observe = batcher._observe

        def checked(group, *args, **kwargs):
            answered_early.extend(i.future.done() for i in group)
            return observe(group, *args, **kwargs)

        batcher._observe = checked
        drive = feed.OfflineFeed(batcher, inflight=2)
        for k in range(3):
            asyncio.run(drive.drive(feed.synthetic_groups(3, 3, seed=k)))
            lanes = batcher.utilization()["lanes"]
            assert lanes["offline"]["items"] == 3 * (k + 1)
    assert answered_early and not any(answered_early)


def test_rescore_route_on_a_bge_micro_server(micro):
    """POST /v1/train/rescore drives the offline lane and answers its
    stats; a body that is not JSON is a default drive, a value that is
    not a number a 400, an overlapping drive a 409."""
    _, port = micro
    client, _ = make_client("port", [])
    with Server(port, chat_client=client.chat_client, score_client=client,
                window_ms=1.0, offline_enabled=True,
                offline_inflight=3) as server:
        (s, _, raw), = port_calls(server, [_post(
            "/v1/train/rescore", {"groups": 5, "n": 4, "seed": 1})])
        stats = json.loads(raw)
        assert s == 200 and stats["ok"] is True
        assert (stats["groups"], stats["items"], stats["errors"]) == (5, 20, 0)
        assert stats["offline_occupancy"] > 0
        assert stats["lanes"]["offline"]["items"] == 5
        assert list(stats) == ["ok", "groups", "items", "errors",
                               "offline_occupancy", "lanes"]
        for bad in ({"groups": "x"}, {"n": [2]}, {"temperature": "hot"}):
            (s, _, raw), = port_calls(server, [_post("/v1/train/rescore",
                                                     bad)])
            assert (s, json.loads(raw)) == (400, {
                "code": 400, "message": "rescore params must be numeric"})
        (s, _, raw), = port_calls(server, [
            ("POST", "/v1/train/rescore", b"{nope", None)])
        assert s == 200 and json.loads(raw)["groups"] == 32
        # an overlapping drive: hold the first one inside the batcher
        gate = threading.Event()
        real = server.batcher.submit_consensus

        def held(*a, **kw):
            gate.wait(30)
            return real(*a, **kw)

        server.batcher.submit_consensus = held
        first = []
        t = threading.Thread(target=lambda: first.extend(port_calls(
            server, [_post("/v1/train/rescore", {"groups": 2, "n": 3})])))
        t.start()
        deadline = time.time() + 30
        while not server.offline_rescore._lock.locked():
            assert time.time() < deadline
            time.sleep(0.01)
        (s, _, raw), = port_calls(server, [_post("/v1/train/rescore", {})])
        gate.set()
        t.join(60)
        server.batcher.submit_consensus = real
        assert (s, json.loads(raw)) == (409, {
            "code": 409, "message": "a rescore drive is already running"})
        assert first[0][0] == 200
        snap = json.loads(port_calls(server, [
            ("GET", "/metrics", None, None)])[0][2])
    assert snap["device_batcher"]["lanes"]["offline"]["dispatches"] >= 1


def test_the_rescore_cli_drives_synthetic_groups(capsys):
    from llm_weighted_consensus_tpu_torch.train.__main__ import main

    env = {"EMBEDDER_MODEL": "test-tiny", "LWC_ALLOW_RANDOM_PARAMS": "1",
           "EMBEDDER_MAX_TOKENS": "32", "BATCH_WINDOW_MS": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        rc = main(["rescore", "--synthetic", "4", "--n", "3", "--inflight",
                   "2", "--device", "cpu"])
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert (stats["groups"], stats["items"], stats["errors"]) == (4, 12, 0)
    assert stats["lanes"]["offline"]["items"] == 4


def test_train_package_exports():
    import llm_weighted_consensus_tpu_torch.train as train

    assert "offline" in train.__doc__
    for name in ("contrastive_train_step", "reward_train_step",
                 "save_train_state", "load_train_state", "make_optimizer"):
        assert name in train.__all__ and hasattr(train, name)
