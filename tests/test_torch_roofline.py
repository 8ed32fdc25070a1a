"""The port's roofline gauge against the JAX package's.

``analysis/roofline.py``'s pure functions (``split_label``, ``sol_ms``,
``tolerance_of``, ``compare_roofline``) and ``RooflineGauge.snapshot``
equal the reference's on the same inputs; ``analysis/cost.py``'s product
terms are within 1% of ``torch.utils.flop_counter.FlopCounterMode`` over
the plain forward (test-tiny on the CPU, a bge-large bucket on the meta
device); the committed ``roofline.json`` matches a fresh count within its
tolerance (the reference's JXA013 gate), its scope names bge-large; and
the port's server serves the ``roofline`` section and both Prometheus
families on the CPU.
"""

import copy
import json
import urllib.request

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from llm_weighted_consensus_tpu.analysis import roofline as ref_roof
from llm_weighted_consensus_tpu.obs import phases as ref_phases
from llm_weighted_consensus_tpu_torch.analysis import cost
from llm_weighted_consensus_tpu_torch.analysis import roofline as roof
from llm_weighted_consensus_tpu_torch.models import bert
from llm_weighted_consensus_tpu_torch.models.configs import PRESETS
from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
from llm_weighted_consensus_tpu_torch.obs import phases
from llm_weighted_consensus_tpu_torch.serve.gateway import Server

LABELS = [
    "vote1(n=8,s=16)", "vote1(n=8,s=16)@dp4xtp2", "many(r=8,n=64,s=128)@dp1xtp1",
    "ring(b=16,s=64)@dp2xtp2xsp2", "embed(b=16,s=32)@cpu", "x@dp1", "@dp1xtp1",
    "packed(b=8,l=512,k=64)",
]
PEAKS = {"tpu": {"flops_per_sec": 1e14, "hbm_bytes_per_sec": 1e12},
         "cuda": dict(roof.DEFAULT_PEAKS["cuda"]),
         "cpu": dict(roof.DEFAULT_PEAKS["cpu"])}


@pytest.fixture(autouse=True)
def _fresh_phases():
    for mod in (phases, ref_phases):
        mod.reset_phases()
    yield
    for mod in (phases, ref_phases):
        mod.reset_phases()


@pytest.mark.parametrize("label", LABELS)
def test_split_label_equals_the_references(label):
    assert roof.split_label(label) == ref_roof.split_label(label)


@pytest.mark.parametrize("figures", [
    {"flops": 4e13, "bytes_accessed": 7e9},
    {"flops": 1e6, "bytes_accessed": 7e9},
    {"flops": "x", "bytes_accessed": 1},
    {"bytes_accessed": 1},
])
@pytest.mark.parametrize("peaks", [
    PEAKS["cuda"], PEAKS["cpu"], {"flops_per_sec": 0, "hbm_bytes_per_sec": 1},
    {"flops_per_sec": 1},
])
@pytest.mark.parametrize("chips", [1, 8])
def test_sol_ms_equals_the_references(figures, peaks, chips):
    assert roof.sol_ms(figures, peaks, chips) == ref_roof.sol_ms(
        figures, peaks, chips)


def test_tolerance_of_equals_the_references():
    for doc in ({}, {"tolerance": {"flops": 0.1}},
                {"tolerance": {"bytes_accessed": "0.5"}}):
        for metric in roof.ROOFLINE_METRICS:
            assert roof.tolerance_of(doc, metric) == ref_roof.tolerance_of(
                doc, metric)
    assert roof.ROOFLINE_METRICS == ref_roof.ROOFLINE_METRICS
    assert roof.DEFAULT_TOLERANCE == ref_roof.DEFAULT_TOLERANCE


def _doc():
    return {
        "scope": {"model": "m"},
        "tolerance": {"flops": 0.25, "bytes_accessed": 0.1},
        "peaks": copy.deepcopy(PEAKS),
        "buckets": {
            "vote1(n=8,s=16)": {"flops": 100.0, "bytes_accessed": 50.0},
            "embed(b=16,s=16)": {"flops": 10.0, "bytes_accessed": 5.0},
            "gone(n=1)": {"flops": 1.0, "bytes_accessed": 1.0},
        },
    }


def _cases():
    measured = {"vote1(n=8,s=16)": {"flops": 120.0, "bytes_accessed": 56.0},
                "embed(b=16,s=16)": {"flops": 10.0, "bytes_accessed": 5.0},
                "many(r=2,n=8,s=16)": {"flops": 1.0, "bytes_accessed": 1.0}}
    bad_peaks = _doc()
    del bad_peaks["peaks"]["cpu"]
    return [
        ("no file", measured, {}, None),
        ("scope mismatch", measured, _doc(), {"model": "other"}),
        ("drift, missing and stale rows", measured, _doc(), {"model": "m"}),
        ("in band", {k: v for k, v in _doc()["buckets"].items()}, _doc(),
         None),
        ("missing cpu peaks", measured, bad_peaks, None),
    ]


def _norm(f, jax_side: bool):
    msg = f.message
    if jax_side:
        msg = msg.replace(
            "python -m llm_weighted_consensus_tpu.analysis.mesh_audit "
            "--write-roofline", roof.CLI).replace("--write-roofline",
                                                  "--write")
    return (f.rule, f.path, f.line, f.symbol, msg)


@pytest.mark.parametrize("measured, doc, scope",
                         [c[1:] for c in _cases()],
                         ids=[c[0] for c in _cases()])
def test_compare_roofline_equals_the_references(measured, doc, scope):
    got = [_norm(f, False) for f in roof.compare_roofline(measured, doc,
                                                          scope)]
    want = [_norm(f, True) for f in ref_roof.compare_roofline(measured, doc,
                                                              scope)]
    assert got == want


def test_the_gauge_equals_the_references():
    for label, values in (("vote1(n=8,s=16)@dp1xtp1", (3.0, 4.0, 5.0)),
                          ("embed(b=16,s=16)", (1.5,)),
                          ("unknown(n=1)", (2.0, 2.0))):
        for ms in values:
            phases.observe_device(label, ms)
            ref_phases.observe_device(label, ms)
    for backend in ("cuda", "cpu", "nope"):
        got = roof.RooflineGauge(_doc(), backend).snapshot()
        want = ref_roof.RooflineGauge(_doc(), backend).snapshot()
        assert got == want
    snap = roof.RooflineGauge(_doc(), "cuda").snapshot()["buckets"]
    assert "sol_ms" in snap["vote1(n=8,s=16)@dp1xtp1"]
    assert "sol_ms" not in snap["unknown(n=1)"]


# -- the counter -----------------------------------------------------------------


def _plain_flops(config, label, device):
    kind, a = cost.parse_label(label)
    with torch.device(device):
        model = bert.BertEncoder(config)
    rows = {"embed": a.get("b"), "vote1": a.get("n"),
            "many": a.get("r", 1) * a.get("n", 1),
            "packed": a.get("b")}[kind]
    s = a.get("l", a.get("s"))
    ids = torch.zeros((rows, s), dtype=torch.int32, device=device)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        if kind == "packed":
            seg = torch.ones((rows, s), dtype=torch.int32, device=device)
            pos = torch.arange(s, dtype=torch.int32,
                               device=device).repeat(rows, 1)
            starts = torch.zeros((rows, a["k"]), dtype=torch.int32,
                                 device=device)
            hidden = bert.encode(model, ids, None, segment_ids=seg,
                                 positions=pos, attention_impl="plain")
            bert.pool_segments(hidden, seg, starts)
        else:
            bert.embed(model, ids, torch.ones_like(ids),
                       attention_impl="plain")
    return counter.get_total_flops()


@pytest.mark.parametrize("name, label, device", [
    ("test-tiny", "embed(b=16,s=16)", "cpu"),
    ("test-tiny", "vote1(n=8,s=32)", "cpu"),
    ("test-tiny", "many(r=4,n=8,s=16)", "cpu"),
    ("test-tiny", "packed(b=2,l=64,k=8)", "cpu"),
    ("bge-large-en", "many(r=8,n=64,s=128)", "meta"),
])
def test_the_counter_is_within_1pct_of_flop_counter_mode(name, label, device):
    config = PRESETS[name]
    want = _plain_flops(config, label, device)
    got = cost.bucket_cost(config, label)["product_flops"]
    assert abs(got - want) <= 0.01 * want, (got, want)
    # the whole count adds the element-wise passes and the vote
    assert cost.bucket_cost(config, label)["flops"] > got


def test_the_committed_file_matches_a_fresh_count():
    doc = roof.load_roofline()
    assert doc["scope"]["model"] == "bge-large-en"
    assert roof.compare_roofline(roof.measure(doc["scope"]), doc,
                                 doc["scope"]) == []
    assert "tpu" not in doc["peaks"]
    assert doc["peaks"]["cuda"] == {"flops_per_sec": 989e12,
                                    "hbm_bytes_per_sec": 3.35e12}
    # the main path's bucket: 65,536 tokens x ~6.2e8 FLOP, ~41 ms at the
    # bf16 peak
    main = roof.sol_ms(doc["buckets"]["many(r=8,n=64,s=128)"],
                       doc["peaks"]["cuda"])
    assert 40.0 < main < 42.0
    assert roof.main([]) == 0


def test_a_drifted_file_fails_the_gate(tmp_path, monkeypatch):
    doc = roof.load_roofline()
    doc["buckets"]["vote1(n=8,s=32)"]["flops"] *= 2
    path = tmp_path / "roofline.json"
    path.write_text(json.dumps(doc))
    monkeypatch.setattr(roof, "default_roofline_path", lambda: path)
    assert roof.main([]) == 1
    assert roof.main(["--write"]) == 0
    assert roof.main([]) == 0
    rewritten = json.loads(path.read_text())
    assert rewritten["peaks"] == doc["peaks"]
    assert rewritten["tolerance"] == doc["tolerance"]


# -- /metrics --------------------------------------------------------------------


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.read().decode()


def test_the_server_serves_the_section_and_both_families():
    emb = TorchEmbedder("test-tiny", max_tokens=32, device="cpu")
    texts = ["one two", "three four five", "six"]
    with Server(emb, window_ms=1.0) as srv:
        # the committed gauge: the CPU row, no row for test-tiny buckets
        srv.batcher.consensus(texts)
        section = json.loads(_get(srv.port, "/metrics"))["roofline"]
        assert section["backend"] == "cpu" and section["known_peaks"]
        (label, row), = section["buckets"].items()
        assert label.startswith("vote1(n=3,") and row["count"] == 1
        assert "sol_ms" not in row
        # a gauge with rows for this server's buckets (test-tiny's count)
        doc = {"peaks": roof.DEFAULT_PEAKS, "buckets": {
            label: cost.bucket_cost(emb.config, label)}}
        srv.metrics.register_provider(
            "roofline", roof.RooflineGauge(doc, "cpu").snapshot)
        row = json.loads(_get(srv.port, "/metrics"))["roofline"][
            "buckets"][label]
        text = _get(srv.port, "/metrics?format=prometheus")
    assert row["sol_ms"] > 0 and row["attainment"] > 0
    lines = text.splitlines()
    for family in ("lwc_roofline_sol_ms", "lwc_roofline_attainment"):
        assert f"# TYPE {family} gauge" in lines
        sample, = [ln for ln in lines if ln.startswith(family + "{")]
        assert f'bucket="{label}"' in sample
        assert np.isfinite(float(sample.rsplit(" ", 1)[1]))
    assert lines[-1] == "# EOF"
