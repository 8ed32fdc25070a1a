"""The port's mesh audit (``analysis/mesh_audit.py``, JXA006-013) and its
budgets (``analysis/budgets.py``, ``budgets.json``) on the CPU.

The audit is clean on the tree, with the port's own committed figures
for exactly the buckets it dispatches; each seeded defect is caught by
its rule (a wrong shard, an unwarmed rung, an uncovered leaf, a dead
rule, a large replicated leaf without an allowlist entry, a forbidden
collective, a tp group across dp rows, a host copy, a budget breach and
a missing or stale entry); ``compare_budgets`` and the rule-coverage and
replication checks give the JAX package's findings on the same inputs
(its ``test_budgets_*`` cases), and the CLI runs the audit.
"""

import json

import numpy as np
import pytest
import torch

from llm_weighted_consensus_tpu.analysis import budgets as ref_budgets
from llm_weighted_consensus_tpu.analysis import mesh_audit as ref_audit
from llm_weighted_consensus_tpu_torch.analysis import budgets, mesh_audit
from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
from llm_weighted_consensus_tpu_torch.parallel import sharding
from llm_weighted_consensus_tpu_torch.resilience import MeshFaultManager

SPECS = ((8, 16),)


@pytest.fixture(scope="module")
def tree_audit():
    """The whole audit once, on the tree (about 30 s on the CPU)."""
    return mesh_audit.audit_in_process()


def test_the_mesh_audit_is_clean_on_the_tree(tree_audit):
    findings, measured = tree_audit
    assert findings == [], "\n".join(f.render() for f in findings)
    committed = budgets.load_budgets()
    assert committed["scope"] == mesh_audit._scope()
    # the reference's scope knobs, and the port's own figures for exactly
    # the buckets it dispatches (none is copied from the reference's file)
    assert committed["scope"] == ref_budgets.load_budgets()["scope"]
    assert set(committed["buckets"]) == set(measured) == set(
        ref_budgets.load_budgets()["buckets"])
    for label, figures in measured.items():
        assert figures == pytest.approx(committed["buckets"][label],
                                        abs=0.1), label


def test_the_scope_and_the_knobs_are_the_references(monkeypatch):
    assert mesh_audit._scope() == ref_audit._scope()
    monkeypatch.setenv("ANALYSIS_MESH_SPECS", "4x16,2x32")
    monkeypatch.setenv("ANALYSIS_MESH_RING_BUCKETS", "")
    monkeypatch.setenv("ANALYSIS_MESH_DP", "2")
    assert mesh_audit._scope() == ref_audit._scope()
    assert mesh_audit._ring_enabled() is ref_audit._ring_enabled() is False


# -- JXA006 / JXA007 ------------------------------------------------------------------


def _tiny():
    return TorchEmbedder("test-tiny", seed=0, device="cpu").model


def test_rule_coverage_catches_an_uncovered_leaf_and_a_dead_rule():
    rules = sharding.bert_partition_rules()
    assert mesh_audit.audit_rule_coverage(rules, _tiny(), "toy") == []
    uncovered = mesh_audit.audit_rule_coverage(rules[1:], _tiny(), "toy")
    assert {f.rule for f in uncovered} == {"JXA006"}
    assert {f.symbol for f in uncovered} == {"token_embed",
                                             "position_embed", "type_embed"}
    assert any("matches NO partition rule" in f.message for f in uncovered)
    dead = rules + (("dead", r"no/such/leaf", ()),)
    found = mesh_audit.audit_rule_coverage(dead, _tiny(), "toy")
    assert [(f.rule, f.symbol) for f in found] == [("JXA006", "dead")]
    assert "matches no param leaf" in found[0].message
    ambiguous = rules + (("again", r"embed_ln/(scale|bias)", ()),)
    found = mesh_audit.audit_rule_coverage(ambiguous, _tiny(), "toy")
    assert {f.symbol for f in found} == {"embed_ln/scale", "embed_ln/bias"}


@pytest.mark.parametrize("quantized", [False, True])
def test_rule_coverage_equals_the_references_on_test_tiny(quantized):
    """The port's findings over its tensors are the reference's over its
    tree (its virtual-device-free half), with a rule dropped too."""
    import jax

    from llm_weighted_consensus_tpu.models import bert as jbert
    from llm_weighted_consensus_tpu.models import configs as jconfigs
    from llm_weighted_consensus_tpu.models import quant as jquant
    from llm_weighted_consensus_tpu.parallel import sharding as jsharding
    from llm_weighted_consensus_tpu_torch.models import quant

    model = _tiny()
    tree = jbert.init_params(jax.random.PRNGKey(0), jconfigs.TEST_TINY)
    if quantized:
        quant.quantize_encoder(model, "int8")
        tree = jquant.quantize_bert_params(tree)
    for drop in (0, 3):
        rules = sharding.bert_partition_rules(quantized=quantized)
        jrules = jsharding.bert_partition_rules(quantized=quantized)
        got = mesh_audit.audit_rule_coverage(
            rules[:drop] + rules[drop + 1:], model, "t")
        want = ref_audit.audit_rule_coverage(
            jrules[:drop] + jrules[drop + 1:], tree, "t")
        assert [(f.rule, f.symbol, f.message) for f in got] == [
            (f.rule, f.symbol, f.message.replace(
                "it would silently fall back to whatever XLA propagates",
                "it would be placed whole on every shard without a "
                "decision")) for f in want]


def test_replication_needs_an_allowlist_entry_and_stale_entries_fail():
    rules = sharding.bert_partition_rules()
    model = _tiny()
    # test-tiny's tables are small: a 1 KiB threshold makes them large
    found, matched = mesh_audit.audit_replication(rules, model, "toy", 1024,
                                                  [])
    assert {f.rule for f in found} == {"JXA007"}
    assert {f.symbol for f in found} >= {"token_embed", "position_embed"}
    assert matched == set()
    allow = budgets.load_budgets()["replicated_allowlist"]
    found, matched = mesh_audit.audit_replication(rules, model, "toy", 1024,
                                                  allow)
    assert {f.symbol for f in found} <= {"layers/attn_out/bias",
                                         "layers/mlp_out/bias",
                                         "layers/attn_ln/scale",
                                         "layers/attn_ln/bias",
                                         "layers/mlp_ln/scale",
                                         "layers/mlp_ln/bias",
                                         "embed_ln/scale", "embed_ln/bias"}
    assert matched == {allow[0]["pattern"]}
    assert budgets.check_allowlist_stale(allow, matched) == []
    stale = budgets.check_allowlist_stale(allow, set())
    assert [f.rule for f in stale] == ["JXA010"]
    assert "stale replicated_allowlist" in stale[0].message


def test_a_stacked_leaf_is_sized_over_its_layers():
    sizes = mesh_audit._leaf_sizes(_tiny())
    size, shape, _dtype, _name = sizes["layers/mlp_in/kernel"]
    layers = TorchEmbedder("test-tiny", device="cpu").config.num_layers
    assert shape[0] == layers and size == int(np.prod(shape)) * 4


# -- JXA008 ---------------------------------------------------------------------------


def _note(op, axis, dps, size=2):
    return {"op": op, "group_size": size, "crosses_process": False,
            "axis": axis, "members": [{"dp": d, "tp": i}
                                      for i, d in enumerate(dps)]}


def test_the_collective_plan_catches_each_regression():
    good = [_note("psum", "tp", [0, 0])] * 4 + [_note("psum", "dp", [0, 1])]
    assert mesh_audit.audit_collectives(good, "t", tp=2, layers=2,
                                        dp_rows=1) == []
    # the tp layout degenerated: no reductions
    found = mesh_audit.audit_collectives(good[4:], "t", tp=2, layers=2,
                                         dp_rows=1)
    assert [f.rule for f in found] == ["JXA008"]
    assert "0 tp reductions" in found[0].message
    # a tp group across dp rows
    crossed = good[:3] + [_note("psum", "tp", [0, 1])]
    found = mesh_audit.audit_collectives(crossed, "t", tp=2, layers=2,
                                         dp_rows=1)
    assert [f.rule for f in found] == ["JXA008"]
    assert "spans dp rows" in found[0].message
    # a forbidden collective
    found = mesh_audit.audit_collectives(
        good + [_note("all_to_all", "tp", [0, 0])], "t", tp=2, layers=2,
        dp_rows=1)
    assert [f.rule for f in found] == ["JXA008"]
    assert "all_to_all" in found[0].message
    # a ring dispatch that never rotated
    found = mesh_audit.audit_collectives(good, "t", tp=2, layers=2,
                                         dp_rows=1, ring=True)
    assert "ppermute" in found[0].message


def test_a_host_copy_inside_the_dispatch_is_caught():
    from llm_weighted_consensus_tpu_torch.analysis import dispatch_audit

    x = torch.ones(3)
    with dispatch_audit.recording() as rec:
        y = x * 2
    assert mesh_audit.audit_host_copies(rec, "t") == []
    with dispatch_audit.recording() as rec:
        float(y.sum().item())
    found = mesh_audit.audit_host_copies(rec, "t")
    assert [f.rule for f in found] == ["JXA008"]
    assert "host transfer" in found[0].message


def test_the_recorded_plan_of_a_tp_dispatch_has_two_reductions_per_layer():
    from llm_weighted_consensus_tpu_torch.parallel import collectives

    emb = mesh_audit._make_embedder("test-tiny", mesh_audit._cpu_mesh(2, 2))
    ids = np.ones((4, 16), np.int32)
    with collectives.recording() as notes:
        emb.embed_tokens(ids, ids)
    layers = emb.config.num_layers
    assert mesh_audit.audit_collectives(notes, "t", tp=2, layers=layers,
                                        dp_rows=2) == []
    tp = [n for n in notes if n.get("axis") == "tp"]
    assert len(tp) == 2 * layers * 2
    assert all(len({m["dp"] for m in n["members"]}) == 1 for n in tp)


# -- JXA011 / JXA012 --------------------------------------------------------------------


def test_a_wrong_shard_is_caught_by_the_parity_gate():
    """A tp shard holding another shard's slice computes other numbers:
    JXA011 names the buckets."""
    mesh = mesh_audit._cpu_mesh(2, 2)
    ref = mesh_audit._make_embedder("test-tiny")
    emb = mesh_audit._make_embedder("test-tiny", mesh)
    emb.warmup(list(SPECS))
    assert mesh_audit.audit_serving_buckets(emb, ref, SPECS, (), ())[0] == []
    # tp shard 1 runs shard 0's slice of every MLP
    cpu = torch.device("cpu")
    for mine, other in zip(emb.mesh_model.shard(1, cpu).encoder.layer,
                           emb.mesh_model.shard(0, cpu).encoder.layer):
        mine.intermediate.dense = other.intermediate.dense
        mine.output.dense = other.output.dense
    found, _ = mesh_audit.audit_serving_buckets(emb, ref, SPECS, (), ())
    assert {f.rule for f in found} == {"JXA011"}
    assert {f.path for f in found} == {"mesh:vote1(n=8,s=16)",
                                       "mesh:embed(b=16,s=16)"}


def test_an_unwarmed_bucket_and_an_eager_dispatch_are_caught():
    mesh = mesh_audit._cpu_mesh(2, 2)
    ref = mesh_audit._make_embedder("test-tiny")
    emb = mesh_audit._make_embedder("test-tiny", mesh)
    found, _ = mesh_audit.audit_serving_buckets(emb, ref, SPECS, (), ())
    assert {f.rule for f in found} == {"JXA008"}
    assert any("no warmed bucket" in f.message for f in found)
    assert any("captured or ran eager" in f.message for f in found)


def test_an_unwarmed_rung_is_caught():
    """The full rung warmed and the ladder not: every fallback rung's
    buckets are missing and its dispatches run eager (JXA012)."""
    emb = mesh_audit._make_embedder("test-tiny", mesh_audit._cpu_mesh(4, 2))
    emb.warmup(list(SPECS))
    ref = mesh_audit._make_embedder("test-tiny")
    manager = MeshFaultManager(emb, shape=(4, 2))
    ids = np.ones((8, 16), np.int32)
    cases = [((ids, ids), ref.consensus_confidence_tokens(ids, ids))]
    found = mesh_audit._ladder_findings(
        manager, emb, cases, lambda: [("vote1", 8, 16)],
        lambda d, t: f"ladder:{d}x{t}",
        lambda a: emb.consensus_confidence_tokens(*a), emb.has_bucket)
    assert {f.rule for f in found} == {"JXA012"}
    assert {f.path for f in found} == {"mesh:ladder:2x2", "mesh:ladder:1x2"}
    assert sum("no warmed bucket" in f.message for f in found) == 2
    # warmed, the same walk is clean
    emb = mesh_audit._make_embedder("test-tiny", mesh_audit._cpu_mesh(4, 2))
    manager = MeshFaultManager(emb, shape=(4, 2))
    manager.warm_ladder(list(SPECS))
    assert mesh_audit._ladder_findings(
        manager, emb, cases, lambda: [("vote1", 8, 16)],
        lambda d, t: f"ladder:{d}x{t}",
        lambda a: emb.consensus_confidence_tokens(*a), emb.has_bucket) == []


# -- JXA009 / JXA010: the reference's budget cases ----------------------------------------

_BUDGETS = {
    "scope": {"model": "toy"},
    "tolerance": {"hbm_bytes": 0.25, "flops": 0.25, "bytes_accessed": 0.25},
    "buckets": {"vote1(n=8,s=16)": {"hbm_bytes": 1000.0, "flops": 2000.0,
                                    "bytes_accessed": 3000.0}},
}
_IN_BAND = {"vote1(n=8,s=16)": {"hbm_bytes": 1100.0, "flops": 2100.0,
                                "bytes_accessed": 2900.0}}
_OVER = {"vote1(n=8,s=16)": {"hbm_bytes": 1500.0, "flops": 2000.0,
                             "bytes_accessed": 3000.0}}
_UNDER = {"vote1(n=8,s=16)": {"hbm_bytes": 500.0, "flops": 2000.0,
                              "bytes_accessed": 3000.0}}
_NEW = {**_IN_BAND, "packed(b=8,l=64,k=8)": {"hbm_bytes": 1.0}}

BUDGET_CASES = {
    "in band": (_IN_BAND, _BUDGETS, {"model": "toy"}),
    "breach": (_OVER, _BUDGETS, {"model": "toy"}),
    "shrunk": (_UNDER, _BUDGETS, {"model": "toy"}),
    "missing entry": (_NEW, _BUDGETS, {"model": "toy"}),
    "stale entry": ({}, _BUDGETS, {"model": "toy"}),
    "scope mismatch": (_IN_BAND, _BUDGETS, {"model": "other"}),
    "no file": (_IN_BAND, {}, {"model": "toy"}),
}


def _same(f):
    return (f.rule, f.path, f.symbol,
            f.message.replace("llm_weighted_consensus_tpu_torch.",
                              "llm_weighted_consensus_tpu."))


@pytest.mark.parametrize("case", list(BUDGET_CASES))
def test_compare_budgets_equals_the_references(case):
    measured, committed, scope = BUDGET_CASES[case]
    got = budgets.compare_budgets(measured, committed, scope=scope)
    want = ref_budgets.compare_budgets(measured, committed, scope=scope)
    assert [_same(f) for f in got] == [_same(f) for f in want]
    rules = {"in band": [], "breach": ["JXA009"], "shrunk": ["JXA009"],
             "missing entry": ["JXA010"], "stale entry": ["JXA010"],
             "scope mismatch": ["JXA010"], "no file": ["JXA010"]}[case]
    assert [f.rule for f in got] == rules


def test_a_budget_breach_on_the_tree_is_caught(tree_audit):
    """The tree's measurements against a committed file with one figure
    halved and one bucket renamed: a breach, a missing and a stale
    entry."""
    _, measured = tree_audit
    committed = json.loads(json.dumps(budgets.load_budgets()))
    committed["buckets"]["vote1(n=8,s=16)"]["flops"] /= 2
    committed["buckets"]["gone(b=1,s=1)"] = committed["buckets"].pop(
        "embed(b=16,s=16)")
    found = budgets.compare_budgets(measured, committed,
                                    scope=mesh_audit._scope())
    assert sorted((f.rule, f.symbol or "") for f in found) == [
        ("JXA009", "vote1(n=8,s=16)"), ("JXA010", ""),
        ("JXA010", "gone(b=1,s=1)")]


def test_write_budgets_keeps_the_policy_and_rewrites_the_figures(tmp_path,
                                                                 tree_audit):
    _, measured = tree_audit
    previous = budgets.load_budgets()
    path = tmp_path / "budgets.json"
    mesh_audit.write_budgets_file(path, measured, previous)
    doc = json.loads(path.read_text())
    for key in ("tolerance", "replicated_threshold_bytes",
                "replicated_allowlist", "scope", "buckets"):
        assert doc[key] == previous[key], key


# -- JXA013 and the CLI -------------------------------------------------------------------


def test_a_bucket_without_a_roofline_row_is_caught(tree_audit):
    from llm_weighted_consensus_tpu_torch.analysis.roofline import (
        load_roofline,
    )

    _, measured = tree_audit
    roofline = load_roofline()
    assert mesh_audit.audit_roofline(measured, roofline) == []
    rows = dict(roofline["buckets"])
    rows.pop("ring(b=16,s=64)")
    found = mesh_audit.audit_roofline(measured, {**roofline,
                                                 "buckets": rows})
    assert {(f.rule, f.symbol) for f in found} == {
        ("JXA013", "ring(b=16,s=64)")}


def test_the_cli_runs_the_mesh_audit(monkeypatch, capsys, tmp_path):
    from llm_weighted_consensus_tpu_torch.analysis import __main__ as cli
    from llm_weighted_consensus_tpu_torch.analysis.engine import Finding

    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"suppressions": []}))
    lint = str(cli.Path(__file__).parent / "fixtures" / "analysis"
               / "lwc002_good.py")
    calls = []
    planted = [Finding("JXA011", "mesh:vote1(n=8,s=16)", 0, "planted")]
    monkeypatch.setattr(mesh_audit, "run_mesh_audit",
                        lambda: calls.append(1) or planted)
    assert cli.main([lint, "--no-jaxpr", "--json", "--baseline",
                     str(empty)]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["mesh_run"] is True and calls == [1]
    assert [f["rule"] for f in out["findings"]] == ["JXA011"]
    monkeypatch.setenv("ANALYSIS_SKIP_MESH", "1")
    assert cli.main([lint, "--no-jaxpr", "--json", "--baseline",
                     str(empty)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["mesh_run"] is False and calls == [1]
