"""The port's consensus-quality aggregates and outcome ledger
(``obs/quality.py``, ``obs/ledger.py``) against the JAX package's.

* ``QualityAggregator``: the cases of ``tests/test_quality.py`` (rates
  and exact weight share, entropy and hedging, top-1 calibration and ECE,
  pairwise kappa, drift, re-configured windows, outcome counters and the
  margin histogram) and seeded random outcome sequences, fed to both
  packages: snapshots, scorecards, summaries and ``prom_snapshot`` equal;
* the Prometheus quality families: the same text;
* ``OutcomeLedger``: ring bound and newest-first index, the JSONL tier,
  disk errors counted and never raised, rotation into sealed shards;
  ledger directories written by either package load in the other;
* the tally seam: both packages' ``ScoreClient`` on the same scripted
  judges feed equal quality snapshots and equal ledger records (ids and
  timestamps masked), and an all-failed panel forces its trace.
"""

import json
import random
from decimal import Decimal

import pytest

from llm_weighted_consensus_tpu import obs as ref_obs
from llm_weighted_consensus_tpu.obs import ledger as ref_ledger
from llm_weighted_consensus_tpu.serve import metrics as ref_metrics
from llm_weighted_consensus_tpu_torch import obs as port_obs
from llm_weighted_consensus_tpu_torch.obs import ledger as port_ledger
from llm_weighted_consensus_tpu_torch.serve import metrics as port_metrics

from fakes import Script
from test_torch_score import PKGS as SCORE_PKGS
from test_torch_score import (
    ballot_keys,
    body,
    go,
    judge_script,
    make_client,
    scripts_for,
)

PKGS = {"ref": ref_obs, "port": port_obs}


@pytest.fixture(autouse=True)
def _fresh_quality():
    # both aggregators are process-global singletons: every test starts
    # and ends from a clean, default-configured slate
    for obs in PKGS.values():
        obs.reset_quality()
        obs.configure_quality(window=64, drift_threshold=0.25)
    yield
    for obs in PKGS.values():
        obs.reset_quality()
        obs.configure_quality(window=64, drift_threshold=0.25)


# -- outcome sequences ---------------------------------------------------------
# a case is a list of outcome specs: (ballots, winner, margin, flags),
# each ballot (model, vote floats or None, weight, error code, index)


def _outcome(obs, spec, trace_id="trace-1"):
    ballots, winner, margin, flags = spec
    judges = [
        obs.JudgeBallot(model=m, model_index=i, weight=Decimal(w), vote=v,
                        error_code=e)
        for m, v, w, e, i in ballots
    ]
    weight_sum = sum((j.weight for j in judges if j.vote is not None),
                     Decimal(0))
    full = {"degraded": False, "quorum_degraded": False, "all_failed": False}
    full.update(flags)
    return obs.Outcome(winner=winner, margin=margin, weight_sum=weight_sum,
                       n_choices=len(next((b[1] for b in ballots if b[1]),
                                          [0, 0])),
                       trace_id=trace_id, judges=judges, **full)


def b(model, vote, weight=1, error=None, index=0):
    return (model, vote, weight, error, index)


def o(ballots, winner=0, margin=0.5, **flags):
    return (ballots, winner, margin, flags)


CASES = {
    "rates_and_weight_share": (
        [o([b("a", [0.8, 0.2], 2), b("b", [0.1, 0.9], 1, index=1)])] * 3
        + [o([b("a", [0.8, 0.2], 2), b("b", None, error=c, index=1)])
           for c in (None, 500, 499)]
    ),
    "entropy_and_hedge": [
        o([b("fence", [0.25, 0.25, 0.25, 0.25]),
           b("decisive", [1.0, 0.0, 0.0, 0.0], index=1)]),
    ],
    "calibration": (
        [o([b("j", [0.95, 0.05])])] * 2 + [o([b("j", [0.45, 0.55])])] * 2
    ),
    "kappa": [
        o([b("a", v[p]), b("b", v[p], index=1), b("c", v[1 - p], index=2)],
          winner=p)
        for p, v in ((p, {0: [0.9, 0.1], 1: [0.1, 0.9]}) for p in (0, 1, 0, 1))
    ],
    "kappa_unanimous": [o([b("a", [1.0, 0.0]), b("b", [1.0, 0.0], index=1)])]
    * 3,
    "drift_collapse": [o([b("j", [1.0, 0.0])])] * 8
    + [o([b("j", [0.0, 1.0])])] * 4,
    "drift_cold": [o([b("j", [0.0, 1.0])])] * 6,
    "outcome_counters": [
        o([b("j", [1.0, 0.0])], margin=0.4),
        o([b("j", [1.0, 0.0])], margin=0.2, degraded=True),
        o([b("j", [1.0, 0.0])], margin=0.2, degraded=True,
          quorum_degraded=True),
        o([b("j", None, error=500)], winner=None, margin=None,
          all_failed=True),
    ],
}


def _random_case(seed: int) -> list:
    """A seeded panel of 5 judges over 3 candidates: soft votes, an
    occasional abstain, error or cancellation, and a judge that turns
    sour halfway (drift)."""
    rng = random.Random(seed)
    out = []
    for r in range(80):
        ballots = []
        for j in range(5):
            roll = rng.random()
            if roll < 0.05:
                ballots.append(b(f"judge-{j}", None,
                                 error=rng.choice((None, 500, 499, 429)),
                                 index=j))
                continue
            # candidate 0 leads, so a judge that turns to 2 drifts
            raw = [rng.random() ** 3 + (0.6 if i == 0 else 0.0)
                   for i in range(3)]
            if j == 4 and r >= 40:
                raw = [0.01, 0.01, 1.0]
            total = sum(raw)
            ballots.append(b(f"judge-{j}", [x / total for x in raw],
                             weight=rng.choice((1, 2, 3)), index=j))
        voted = [x for x in ballots if x[1] is not None]
        if not voted:
            out.append(o(ballots, winner=None, margin=None, all_failed=True))
            continue
        sums = [sum(x[1][i] * x[2] for x in voted) for i in range(3)]
        ranked = sorted(sums, reverse=True)
        out.append(o(ballots, winner=sums.index(ranked[0]),
                     margin=(ranked[0] - ranked[1]) / sum(sums),
                     degraded=rng.random() < 0.1))
    return out


for _seed in (1, 2, 3):
    CASES[f"seeded_{_seed}"] = _random_case(_seed)


def _feed(obs, case, window=64, threshold=0.25, trace_ids=True):
    agg = obs.QualityAggregator(window=window, drift_threshold=threshold)
    for n, spec in enumerate(case):
        agg.observe_outcome(_outcome(
            obs, spec, f"{n + 1:032x}" if trace_ids else None))
    return agg


def _prom(agg) -> dict:
    snap = agg.prom_snapshot()
    snap["margin"] = snap["margin"].to_json_obj()
    if snap["exemplar"] is not None:  # its timestamp is the wall clock
        snap["exemplar"] = snap["exemplar"][:2]
    return snap


def _views(agg) -> dict:
    models = sorted({m for m in agg.snapshot()["judges"]}) + ["nope"]
    return {
        "snapshot": agg.snapshot(),
        "scorecards": agg.scorecards(),
        "scorecard": {m: agg.scorecard(m) for m in models},
        "summary": agg.summary(),
        "prom": _prom(agg),
    }


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("window,threshold", [(64, 0.25), (4, 0.3)])
def test_aggregator_matches_the_reference(case, window, threshold):
    got = _views(_feed(port_obs, CASES[case], window, threshold))
    want = _views(_feed(ref_obs, CASES[case], window, threshold))
    assert got == want


def test_aggregator_cases_hold_the_reference_values():
    a = _feed(port_obs, CASES["rates_and_weight_share"])
    assert a.scorecard("a")["weight_share"] == float(
        Decimal(2 * 6) / Decimal(3 * 3 + 2 * 3))
    assert a.scorecard("b")["cancelled_rate"] == round(1 / 6, 4)
    drift = _feed(port_obs, CASES["drift_collapse"], 4, 0.3)
    assert drift.snapshot()["flagged"] == ["j"]
    kappa = _feed(port_obs, CASES["kappa"]).snapshot()["pairwise_kappa"]
    assert kappa["a|b"]["kappa"] == 1.0 and kappa["a|c"]["kappa"] == -1.0
    seeded = _feed(port_obs, CASES["seeded_1"], 8, 0.25)
    assert "judge-4" in seeded.snapshot()["flagged"]


def test_configure_rebounds_existing_windows_as_the_reference():
    views = {}
    for name, obs in PKGS.items():
        agg = _feed(obs, CASES["drift_collapse"], 4, 0.3)
        agg.configure(window=2, drift_threshold=0.7)
        views[name] = _views(agg)
    assert views["port"] == views["ref"]
    drift = views["port"]["scorecard"]["j"]["drift"]
    assert drift["window"] == 2 and drift["agreement_drop"] == 0.8


def test_module_singleton_and_reset_match_the_reference():
    for obs in PKGS.values():
        obs.configure_quality(window=3, drift_threshold=0.5)
        for spec in CASES["seeded_2"][:20]:
            obs.observe_outcome(_outcome(obs, spec, None))
    assert port_obs.quality_snapshot() == ref_obs.quality_snapshot()
    assert port_obs.quality_summary() == ref_obs.quality_summary()
    port_obs.reset_quality()
    assert port_obs.quality_snapshot()["requests"] == 0
    assert port_obs.quality_aggregator().window == 3


def test_prometheus_quality_families_match_the_reference():
    for obs in PKGS.values():
        for n, spec in enumerate(CASES["seeded_3"]):
            obs.observe_outcome(_outcome(obs, spec, None))
    texts = [mod.render_prometheus(mod.Metrics())
             for mod in (port_metrics, ref_metrics)]
    families = ("lwc_confidence_margin", "lwc_consensus_outcomes",
                "lwc_judge_agreement", "lwc_judge_drift")

    def pick(text):
        return [ln for ln in text.splitlines()
                if any(f in ln for f in families)]

    port, ref = (pick(t) for t in texts)
    assert port == ref and len(port) > 20
    assert "quality" in port_metrics.KNOWN_SECTIONS
    assert "ledger" in port_metrics.KNOWN_SECTIONS


def test_margin_exemplar_rides_its_bucket_line():
    port_obs.observe_outcome(_outcome(port_obs, CASES["drift_cold"][0],
                                      "ab" * 16))
    text = port_metrics.render_prometheus(port_metrics.Metrics())
    lines = [ln for ln in text.splitlines() if "trace_id=" in ln]
    assert len(lines) == 1
    assert lines[0].startswith("lwc_confidence_margin_bucket")
    assert '# {trace_id="' + "ab" * 16 + '"} 0.5 ' in lines[0]


# -- the outcome ledger ------------------------------------------------------------


def test_ledger_ring_bound_and_newest_first_match_the_reference():
    out = {}
    for name, obs in PKGS.items():
        ledger = obs.OutcomeLedger(capacity=3)
        for i in range(5):
            ledger.offer({"id": f"r{i}", "winner": i})
        ledger.offer({"winner": 9})  # no id: keyed by its ordinal
        out[name] = (ledger.snapshot(), ledger.index(), ledger.index(limit=1),
                     ledger.get("r0"), ledger.get("r4"), ledger.get("outcome-5"))
    assert out["port"] == out["ref"]
    snap, index = out["port"][:2]
    assert snap["size"] == 3 and snap["kept"] == 6
    assert [r.get("id") for r in index] == [None, "r4", "r3"]


def test_ledger_disk_jsonl_matches_the_reference(tmp_path):
    lines = {}
    for name, obs in PKGS.items():
        ledger = obs.OutcomeLedger(capacity=2, disk_dir=str(tmp_path / name))
        for i in range(4):
            ledger.offer({"id": f"r{i}", "confidence": [0.25, 0.75]})
        path = ledger.snapshot()["disk_path"]
        with open(path, encoding="utf-8") as f:
            lines[name] = f.read()
        assert ledger.snapshot()["disk_errors"] == 0
    assert lines["port"] == lines["ref"]
    assert [json.loads(ln)["id"] for ln in lines["port"].splitlines()] == [
        "r0", "r1", "r2", "r3"]


def test_ledger_disk_error_never_raises(tmp_path):
    ledger = port_obs.OutcomeLedger(capacity=2, disk_dir=str(tmp_path))
    # a directory in place of the file: every append fails with OSError
    ledger._disk_path = str(tmp_path)
    ledger.offer({"id": "r0"})
    assert ledger.snapshot()["disk_errors"] == 1
    assert ledger.get("r0") is not None


def _write_shards(obs, disk_dir, n=12, rotate=300):
    ledger = obs.OutcomeLedger(capacity=4, disk_dir=disk_dir,
                               rotate_bytes=rotate)
    for i in range(n):
        ledger.offer({"id": f"req-{i:02d}", "n_choices": 2,
                      "confidence": [i / n, 1 - i / n],
                      "judges": [{"model": "a", "vote": [1.0, 0.0],
                                  "weight": 1.5, "alignment": 0.5}]})
    return ledger


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_ledger_shards_load_across_the_packages(tmp_path, writer, reader):
    loaders = {"ref": ref_ledger, "port": port_ledger}
    ledger = _write_shards(PKGS[writer], str(tmp_path))
    assert ledger.snapshot()["rotations"] >= 2
    # a torn tail, as a replica killed mid-append leaves
    with open(ledger.snapshot()["disk_path"], "a", encoding="utf-8") as f:
        f.write('{"id": "torn", "n_cho')
    records, torn = loaders[reader].load_ledger_records(str(tmp_path))
    assert torn == 1
    assert [r["id"] for r in records] == [f"req-{i:02d}" for i in range(12)]
    assert all(r["schema"] == "lwc.outcome.v1" for r in records)
    paths = loaders[reader].ledger_shard_paths(str(tmp_path))
    assert paths == loaders[writer].ledger_shard_paths(str(tmp_path))
    for path in paths:
        assert loaders[reader].read_shard_records(path) == \
            loaders[writer].read_shard_records(path)


def test_ledger_rotation_matches_the_reference(tmp_path):
    snaps = {}
    for name, obs in PKGS.items():
        snap = _write_shards(obs, str(tmp_path / name)).snapshot()
        snap.pop("disk_path")
        snaps[name] = snap
    assert snaps["port"] == snaps["ref"]


def test_load_of_a_missing_directory_is_empty():
    assert port_ledger.load_ledger_records("/nonexistent/lwc-ledger") == \
        ref_ledger.load_ledger_records("/nonexistent/lwc-ledger") == ([], 0)


# -- the tally seam ------------------------------------------------------------------


def _masked(record: dict) -> dict:
    return {k: v for k, v in record.items() if k not in ("id", "created")}


@pytest.mark.parametrize("scenario", ["split", "agree", "one_failed"])
def test_tally_seam_feeds_quality_and_ledger_as_the_reference(scenario):
    keys = ballot_keys(3)
    judges = [{"model": "judge-a", "weight": {"type": "static", "weight": 2}},
              {"model": "judge-b"}, {"model": "judge-c"}]
    by_model = {
        "split": {"judge-a": judge_script(keys[0]),
                  "judge-b": judge_script(keys[1]),
                  "judge-c": judge_script(keys[2])},
        "agree": {m: judge_script(keys[1])
                  for m in ("judge-a", "judge-b", "judge-c")},
        "one_failed": {"judge-a": judge_script(keys[1]),
                       "judge-b": Script(status=500, body=b"{}"),
                       "judge-c": judge_script(keys[0])},
    }[scenario]
    scripts = scripts_for(judges, by_model) * 2
    out = {}
    for pkg, obs in (("ref", ref_obs), ("port", port_obs)):
        ledger = obs.OutcomeLedger(capacity=8)
        client, _ = make_client(pkg, scripts, ledger=ledger)
        params = _params(pkg, judges)
        for _ in range(2):
            go(_collect(client, params))
        out[pkg] = ([_masked(r) for r in ledger.index()],
                    obs.quality_snapshot())
    assert out["port"] == out["ref"]
    records, snap = out["port"]
    assert len(records) == 2 and snap["requests"] == 2
    assert all(r["trace_id"] is None for r in records)


def test_all_failed_forces_the_trace_in_both():
    judges = [{"model": "judge-a"}, {"model": "judge-b"}]
    scripts = [Script(status=418, body=b"{}"), Script(status=418, body=b"{}")]
    got = {}
    for pkg, obs in (("ref", ref_obs), ("port", port_obs)):
        client, _ = make_client(pkg, scripts)
        params = _params(pkg, judges)

        async def run():
            root = obs.start_trace("test:root", sampled=False)
            token = root.activate()
            try:
                items = await _collect(client, params)
            finally:
                obs.Span.deactivate(token)
                root.finish()
            return root.trace, items

        trace, items = go(run())
        got[pkg] = (trace.forced, trace.force_reason,
                    obs.quality_snapshot()["outcomes"],
                    type(items[-1]).__name__)
    assert got["port"] == got["ref"] == (
        True, "all_failed",
        {"scored": 0, "degraded": 0, "quorum_degraded": 0, "all_failed": 1},
        "AllVotesFailed")


def _params(pkg, judges):
    return SCORE_PKGS[pkg].req.ChatCompletionCreateParams.from_json_obj(
        body(judges))


async def _collect(client, params):
    stream = await client.create_streaming(None, params)
    return [item async for item in stream]
