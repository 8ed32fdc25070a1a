"""The port's live judge-weight tables (``weights/live.py``) against the
reference's: content-addressed versions byte for byte, ``apply`` and the
``base`` version, validation, the ``lwc.weights.v1`` file (each package
loads the other's), the shadow counters on the same ballots, the config
factory and the ``weights`` metrics section, and the lock that lets a
handler thread swap while the loop thread tallies."""

import sys
import threading
from decimal import Decimal

import pytest

from llm_weighted_consensus_tpu import obs as jobs
from llm_weighted_consensus_tpu.identity.model import ModelBase as JModelBase
from llm_weighted_consensus_tpu.serve import Config
from llm_weighted_consensus_tpu.serve.metrics import (
    Metrics as JMetrics,
    register_quality as j_register_quality,
    render_prometheus as j_render_prometheus,
)
from llm_weighted_consensus_tpu.weights import live as jlive
from llm_weighted_consensus_tpu_torch import obs as tobs
from llm_weighted_consensus_tpu_torch.identity.model import ModelBase
from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig
from llm_weighted_consensus_tpu_torch.serve.metrics import (
    KNOWN_SECTIONS,
    Metrics,
    register_quality,
    render_prometheus,
)
from llm_weighted_consensus_tpu_torch.weights import live

TABLES = [
    {"a": 1, "b": 2},
    {"b": 2, "a": 1},
    {"j": 1.5, "k": 0.1, "l": 1e-7, "m": 3.0},
    {"j": "1.50", "k": "2", "l": "0.000001"},
    {"j": Decimal("1.50"), "k": Decimal("2E+1"), "l": Decimal("0.1")},
    {"x|y": 0, "wv-name": 12345678901234567890},
    {"judge": 0.1 + 0.2},
]


@pytest.mark.parametrize("table", TABLES)
def test_versions_are_the_references_byte_for_byte(table):
    version = live.weights_version(table)
    assert version == jlive.weights_version(table)
    assert version.startswith("wv-") and len(version) == 15


def test_versions_are_content_addressed():
    v1 = live.weights_version({"b": 2, "a": 1})
    assert v1 == live.weights_version({"a": 1, "b": 2})
    assert v1 != live.weights_version({"a": 1, "b": 3})


def _models():
    judges = [{"model": "judge-a"}, {"model": "judge-b"}]
    return (
        ModelBase.from_json_obj({"llms": judges}).into_model_validate(),
        JModelBase.from_json_obj({"llms": judges}).into_model_validate(),
    )


def test_apply_and_the_base_version_as_the_reference():
    model, jmodel = _models()
    assert [llm.id for llm in model.llms] == [llm.id for llm in jmodel.llms]
    store, jstore = live.LiveWeightStore(), jlive.LiveWeightStore()
    fetched = [Decimal(1), Decimal(1)]
    out, version = store.apply(model, fetched)
    assert out is fetched and version == live.BASE_VERSION == "base"
    target = model.llms[0]
    version = store.put({target.id: 5})
    assert version == jstore.put({target.id: 5})
    out, applied = store.apply(model, fetched)
    assert (out, applied) == jstore.apply(jmodel, fetched)
    assert applied == version == store.version
    assert out[target.index] == Decimal(5)
    # judges absent from the table keep their fetched weight
    assert out[model.llms[1].index] == Decimal(1)
    assert store.snapshot() == jstore.snapshot()
    store.clear(mode="active")
    assert store.apply(model, fetched)[1] == live.BASE_VERSION


@pytest.mark.parametrize("bad", [{"j": -1}, {"j": "nan"}, {"j": "zebra"},
                                 {"j": "inf"}, {"j": None}, {}])
def test_bad_tables_are_refused_as_the_reference_refuses_them(bad):
    with pytest.raises(ValueError) as want:
        jlive.LiveWeightStore().put(bad)
    with pytest.raises(ValueError) as got:
        live.LiveWeightStore().put(bad)
    assert str(got.value) == str(want.value)


def test_a_bad_mode_is_refused():
    with pytest.raises(ValueError, match="mode"):
        live.LiveWeightStore().put({"j": 1}, mode="canary")


def test_persistence_and_each_package_loads_the_others_file(tmp_path):
    port_path = str(tmp_path / "port.json")
    ref_path = str(tmp_path / "ref.json")
    stores = (live.LiveWeightStore(path=port_path),
              jlive.LiveWeightStore(path=ref_path))
    for store in stores:
        store.put({"j": "1.5", "k": 2})
        store.put({"j": 1}, mode="shadow")
    # byte-equal files
    with open(port_path, "rb") as a, open(ref_path, "rb") as b:
        assert a.read() == b.read()
    assert stores[0].snapshot()["swaps"] == 2
    for path in (port_path, ref_path):
        port, ref = live.LiveWeightStore(path), jlive.LiveWeightStore(path)
        assert port.wire() == ref.wire() == stores[1].wire()
        assert port.version == stores[0].version
        assert port.wire()["weights"] == {"j": "1.5", "k": "2"}
        assert port.wire()["shadow"]["version"] == stores[0].wire()[
            "shadow"]["version"]
    # a cleared slot persists too
    stores[0].clear(mode="shadow")
    assert jlive.LiveWeightStore(port_path).wire()["shadow"] is None


def _ballots(pkg, weights):
    return [
        pkg.JudgeBallot(model=m, model_index=i, weight=Decimal(w),
                        vote=v, error_code=None)
        for i, (m, w, v) in enumerate(weights)
    ]


BALLOTS = [
    [("a", 1, [1.0, 0.0]), ("c", 3, [0.0, 1.0])],
    [("a", 1, [0.25, 0.75]), ("c", 3, [0.6, 0.4]), ("b", 2, None)],
    [("a", 1, [0.5, 0.25, 0.25]), ("c", 3, [0.1, 0.1, 0.8]),
     ("b", 2, [0.0, 1.0, 0.0])],
]


def test_shadow_counters_are_the_references_on_the_same_ballots():
    store, jstore = live.LiveWeightStore(), jlive.LiveWeightStore()
    for ballots in BALLOTS:  # no shadow table staged: a no-op
        store.observe_shadow(_ballots(tobs, ballots), 2)
    assert store.shadow_compared == 0
    for table in ({"c": "0.5"}, {"c": 3}, {"a": 9, "b": "0.01"}):
        store.put(table, mode="shadow")
        jstore.put(table, mode="shadow")
        for ballots in BALLOTS:
            n = max(len(v) for _, _, v in ballots if v)
            store.observe_shadow(_ballots(tobs, ballots), n)
            jstore.observe_shadow(_ballots(jobs, ballots), n)
    snap = store.snapshot()
    assert snap == jstore.snapshot()
    assert snap["shadow_compared"] == 9
    assert 0 < snap["shadow_would_flip"] < 9
    assert snap["shadow_confidence_delta_sum"] > 0


def test_the_config_factory_is_the_references(tmp_path):
    assert ServeConfig.from_env({}).live_weights() is None
    store = ServeConfig.from_env({"WEIGHTS_ENABLED": "1"}).live_weights()
    assert store is not None and store.path is None
    path = str(tmp_path / "w.json")
    jlive.LiveWeightStore(path).put({"j": 2})
    store = ServeConfig.from_env({"WEIGHTS_PATH": path}).live_weights()
    want = Config.from_env({"WEIGHTS_PATH": path}).live_weights()
    assert store.path == path and store.snapshot() == want.snapshot()
    assert store.wire() == want.wire()
    with pytest.raises(ValueError, match="OFFLINE_INFLIGHT"):
        ServeConfig.from_env({"OFFLINE_ENABLED": "1",
                              "OFFLINE_INFLIGHT": "0"})


def test_the_weights_section_and_families_are_the_references():
    assert "weights" in KNOWN_SECTIONS
    metrics, jmetrics = Metrics(), JMetrics()
    store, jstore = live.LiveWeightStore(), jlive.LiveWeightStore()
    for s in (store, jstore):
        s.put({"j": 1})
        s.put({"j": 2}, mode="shadow")
    store.observe_shadow(_ballots(tobs, BALLOTS[0]), 2)
    jstore.observe_shadow(_ballots(jobs, BALLOTS[0]), 2)
    register_quality(metrics, live_weights=store)
    j_register_quality(jmetrics, live_weights=jstore)
    assert metrics.snapshot()["weights"] == jmetrics.snapshot()["weights"]
    assert metrics.snapshot()["weights"]["swaps"] == 2

    def family(text):
        return [line for line in text.splitlines()
                if "lwc_weights_" in line]

    got = family(render_prometheus(metrics))
    assert got == family(j_render_prometheus(jmetrics))
    assert "lwc_weights_swaps_total 2" in got
    assert 'lwc_weights_shadow_total{kind="compared"} 1' in got
    # without a store: no section, no family
    bare = Metrics()
    register_quality(bare)
    assert "weights" not in bare.snapshot()
    assert not family(render_prometheus(bare))


def test_swaps_and_tallies_from_many_threads_count_every_call():
    """A PUT arrives on a handler thread while tallies run on the loop
    thread: with the lock no counter update is lost, and every apply sees
    one whole table."""
    model, _ = _models()
    store = live.LiveWeightStore()
    target = model.llms[0]
    tables = [{target.id: w, model.llms[1].id: w} for w in (1, 2)]
    versions = {live.weights_version(t): t for t in tables}
    seen = []

    def swapper():
        for k in range(400):
            store.put(tables[k % 2])
            store.put(tables[k % 2], mode="shadow")

    def tallier():
        for _ in range(400):
            out, version = store.apply(model, [Decimal(7), Decimal(7)])
            seen.append((out, version))
            store.observe_shadow(_ballots(tobs, BALLOTS[0]), 2)

    threads = [threading.Thread(target=swapper)] + [
        threading.Thread(target=tallier) for _ in range(3)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert store.swaps == 800
    applied = sum(v != live.BASE_VERSION for _, v in seen)
    assert store.applied == applied
    for out, version in seen:
        if version == live.BASE_VERSION:
            continue
        # both judges from the same table: never a mix of two versions
        w = versions[version][target.id]
        assert out == [Decimal(w), Decimal(w)]
    compared = store.shadow_compared
    assert 0 < compared <= 1200
    for _ in range(10):
        store.observe_shadow(_ballots(tobs, BALLOTS[0]), 2)
    assert store.shadow_compared == compared + 10
