"""The port's analysis gate (``llm_weighted_consensus_tpu_torch.analysis``),
held against the reference's (``llm_weighted_consensus_tpu.analysis``).

* fixture parity — for every rule that keeps the reference's predicate,
  both engines give identical findings (rule, line, symbol, message) on
  each ``tests/fixtures/analysis/lwcNNN_{bad,good}.py``, and both give
  zero on the JAX tree (after the reference's baseline);
* the port-only predicates — LWC009 (torch calls and device syncs in a
  coroutine) and LWC013 (CUDA syncs outside the waiter seam), on sources
  written into ``tmp_path``;
* the baseline machinery, the CLI's exit codes, and the package itself:
  the port lints clean against its own baseline, its registry covers
  every threading primitive both ways, and the lint alone never imports
  torch.

The whole-package lint runs once per module (``package_findings``).
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from llm_weighted_consensus_tpu.analysis import engine as ref_engine
from llm_weighted_consensus_tpu.analysis.rules import (
    RULES_BY_NAME as REF_RULES,
)
from llm_weighted_consensus_tpu_torch.analysis import (
    apply_baseline,
    baseline_entry,
    default_baseline_path,
    load_baseline,
    run_lint,
)
from llm_weighted_consensus_tpu_torch.analysis.rules import (
    ALL_RULES,
    RULES_BY_NAME,
)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "analysis"
PORT_ONLY = ("LWC009", "LWC013")
SAME = sorted(set(RULES_BY_NAME) - set(PORT_ONLY))
CONC = ("LWC014", "LWC015", "LWC016")


def _key(findings):
    return [(f.rule, f.path, f.line, f.symbol, f.message) for f in findings]


@pytest.fixture(scope="module")
def package_findings():
    """The whole port linted once, every rule."""
    return run_lint()


# -- the registry ----------------------------------------------------------------


def test_rule_ids_are_the_references():
    assert [r.name for r in ALL_RULES] == sorted(REF_RULES)
    assert sorted(RULES_BY_NAME) == sorted(REF_RULES)


# -- fixture parity ---------------------------------------------------------------


@pytest.mark.parametrize("kind", ["bad", "good"])
@pytest.mark.parametrize("rule", SAME)
def test_fixture_findings_equal_the_references(rule, kind):
    path = FIXTURES / f"{rule.lower()}_{kind}.py"
    got = run_lint(paths=[path], rules=[RULES_BY_NAME[rule]])
    want = ref_engine.run_lint(paths=[path], rules=[REF_RULES[rule]])
    assert _key(got) == _key(want)
    assert bool(got) == (kind == "bad")


@pytest.mark.parametrize("rule", SAME)
def test_good_fixture_clean_under_every_port_rule(rule):
    """A conforming fixture trips none of the port's rules (the
    port-only predicates included)."""
    findings = run_lint(paths=[FIXTURES / f"{rule.lower()}_good.py"])
    assert findings == [], [f.render() for f in findings]


def test_both_engines_clean_on_the_jax_tree():
    files = ref_engine.source_files()
    ref_base = ref_engine.load_baseline()
    got = run_lint(paths=files, rules=[RULES_BY_NAME[r] for r in SAME])
    kept, _, _ = apply_baseline(got, ref_base)
    assert kept == [], "\n".join(f.render() for f in kept)
    want, _, _ = ref_engine.apply_baseline(
        ref_engine.run_lint(paths=files, rules=[REF_RULES[r] for r in SAME]),
        ref_base)
    assert want == []


# -- the port-only predicates ----------------------------------------------------

LWC009_BAD = '''
import torch


async def handler(buf, conf):
    x = torch.zeros(4)
    torch.cuda.synchronize()
    top = conf.item()
    return buf.cpu(), conf.tolist(), x, top
'''

LWC009_GOOD = '''
import asyncio

import torch


def on_thread(buf):
    return torch.zeros(4), buf.cpu()


async def handler(loop, buf):
    out = await loop.run_in_executor(None, on_thread, buf)

    def later():
        return buf.item()

    return out, later
'''

LWC013_BAD = '''
import torch


def dispatch(graph, out, done):
    graph.replay()
    torch.cuda.synchronize()
    done.synchronize()
    return out.cpu(), out.item(), out.tolist()
'''

LWC013_GOOD = '''
import torch


def wait_device_ready(out):
    out.synchronize()


def dispatch(graph, out, host):
    graph.replay()
    host.copy_(out, non_blocking=True)
    return host
'''


def _write(tmp_path, rel, source):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(source)
    return path


def _port_lint(path, rule, rel_to):
    return run_lint(paths=[path], rules=[RULES_BY_NAME[rule]], rel_to=rel_to)


def test_lwc009_flags_torch_calls_and_syncs_in_a_coroutine(tmp_path):
    path = _write(tmp_path, "serve/routes.py", LWC009_BAD)
    findings = _port_lint(path, "LWC009", tmp_path)
    assert [f.line for f in findings] == [6, 7, 8, 9, 9]
    assert {f.symbol for f in findings} == {"handler"}
    assert "`torch.cuda.synchronize(...)`" in findings[1].message
    assert "`.item()`" in findings[2].message
    # the reference's predicate sees none of these
    assert ref_engine.run_lint(paths=[path], rules=[REF_RULES["LWC009"]],
                               rel_to=tmp_path) == []


def test_lwc009_silent_off_the_loop_and_at_the_boundary(tmp_path):
    path = _write(tmp_path, "serve/routes.py", LWC009_GOOD)
    assert _port_lint(path, "LWC009", tmp_path) == []
    boundary = _write(tmp_path, "serve/batcher.py", LWC009_BAD)
    assert _port_lint(boundary, "LWC009", tmp_path) == []


def test_lwc013_flags_syncs_on_the_dispatch_path(tmp_path):
    path = _write(tmp_path, "llm_weighted_consensus_tpu_torch/models/x.py",
                  LWC013_BAD)
    findings = _port_lint(path, "LWC013", tmp_path)
    assert [f.line for f in findings] == [7, 8, 9, 9, 9]
    assert {f.symbol for f in findings} == {"dispatch"}
    assert "torch.cuda.synchronize" in findings[0].message
    # outside models/ and ops/ a host copy is not judged, a sync still is
    other = _write(tmp_path, "llm_weighted_consensus_tpu_torch/serve/y.py",
                   LWC013_BAD)
    assert [f.line for f in _port_lint(other, "LWC013", tmp_path)] == [7, 8]


def test_lwc013_allows_the_waiter_and_exempt_packages(tmp_path):
    path = _write(tmp_path, "llm_weighted_consensus_tpu_torch/models/x.py",
                  LWC013_GOOD)
    assert _port_lint(path, "LWC013", tmp_path) == []
    for pkg in ("train", "bench", "analysis"):
        exempt = _write(
            tmp_path, f"llm_weighted_consensus_tpu_torch/{pkg}/x.py",
            LWC013_BAD)
        assert _port_lint(exempt, "LWC013", tmp_path) == []


@pytest.mark.parametrize("rel, exempt", [
    ("llm_weighted_consensus_tpu_torch/bench/x.py", True),
    ("llm_weighted_consensus_tpu_torch/ops/_build.py", True),
    ("llm_weighted_consensus_tpu_torch/analysis/x.py", True),
    ("llm_weighted_consensus_tpu_torch/serve/config.py", True),
    ("llm_weighted_consensus_tpu_torch/serve/x.py", False),
    ("llm_weighted_consensus_tpu_torch/train/__main__.py", False),
    ("llm_weighted_consensus_tpu_torch/ops/kernels.py", False),
])
def test_lwc008_exempts_the_bootstrap_by_construction(tmp_path, rel, exempt):
    path = _write(tmp_path, rel,
                  "import os\n\n\ndef f():\n    return os.environ.get('X')\n")
    findings = _port_lint(path, "LWC008", tmp_path)
    assert (findings == []) == exempt


# -- the baseline machinery -------------------------------------------------------


def test_baseline_round_trip(tmp_path):
    findings = run_lint(paths=[FIXTURES / "lwc001_bad.py"])
    assert findings
    entries = [baseline_entry(f, "fixture: intentionally bad")
               for f in findings]
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"suppressions": entries}))
    kept, suppressed, stale = apply_baseline(findings, load_baseline(path))
    assert kept == [] and len(suppressed) == len(findings) and stale == []
    clean = run_lint(paths=[FIXTURES / "lwc001_good.py"])
    kept2, _, stale2 = apply_baseline(clean, load_baseline(path))
    assert kept2 == clean and len(stale2) == len(entries)


def test_baseline_reason_is_mandatory(tmp_path):
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"suppressions": [
        {"rule": "LWC001", "path": "x.py", "symbol": None}]}))
    with pytest.raises(ValueError, match="reason"):
        load_baseline(path)


def test_committed_baseline_is_small_and_reasoned():
    data = json.loads(default_baseline_path().read_text())
    assert data["_doc"].strip()
    entries = load_baseline(default_baseline_path())
    assert len(entries) <= 10
    assert all(str(e["reason"]).strip() for e in entries)


# -- the package -------------------------------------------------------------------


def test_package_lints_clean_against_its_baseline(package_findings):
    kept, _, stale = apply_baseline(package_findings, load_baseline())
    assert stale == [], stale
    assert kept == [], "\n".join(f.render() for f in kept)


def test_the_references_findings_on_the_parent_are_fixed_or_baselined(
        package_findings):
    """The twelve findings the reference's lint gave on the port before
    this slice: the slot leak, the env reads and the unbounded reads are
    gone; what stays is baselined with a reason."""
    live = {(f.rule, f.path.rsplit("llm_weighted_consensus_tpu_torch/", 1)[
        -1], f.symbol) for f in package_findings}
    for fixed in (
        ("LWC003", "serve/batcher.py", "DeviceBatcher._plan_round"),
        ("LWC008", "serve/__main__.py", "main"),
        ("LWC008", "train/__main__.py", "_cmd_rescore"),
        ("LWC008", "ops/_build.py", "_nvcc"),
        ("LWC008", "bench/headline.py", "build"),
        ("LWC008", "bench/http.py", "bench_trace_overhead"),
        ("LWC008", "bench/http.py", "run_http"),
        ("LWC018", "clients/chat.py", "_StdlibResponse.read_body"),
    ):
        assert fixed not in live
    baselined = {(e["rule"], e["symbol"]) for e in load_baseline()}
    assert {("LWC003", "overlap_overhead_record"),
            ("LWC003", "overlap_overhead_record.staging_cycle"),
            ("LWC018", "spm_proto"),
            ("LWC018", "spm_proto.varint")} <= baselined


def test_package_model_covers_every_primitive_both_ways(package_findings):
    drift = [f for f in package_findings if f.rule == "LWC014" and (
        "not in the lock-model registry" in f.message
        or "no creation site" in f.message)]
    assert drift == [], "\n".join(f.render() for f in drift)
    from llm_weighted_consensus_tpu_torch.analysis.concurrency import (
        lock_sites,
        load_model,
    )
    from llm_weighted_consensus_tpu_torch.analysis.engine import (
        parse_module,
        source_files,
    )

    modules = [parse_module(p) for p in source_files()]
    model = load_model(modules)
    sites = {s.key for s in lock_sites(modules, model)}
    assert sites == set(model.locks)
    # the port's 26 serving primitives, the witness's own leaf mutex and
    # the witness bench's bare lock
    assert len(sites) == 28
    for key in ("launch_lock.lock", "DeviceBatcher._cond",
                "DeviceBatcher._embed_lock",
                "DeviceBatcher._submit_embed_cached.lock",
                "_ShapeGate._cond", "MeshFaultManager._lock",
                "StagingPool._lock", "launches._lock"):
        assert key in sites
    # long-held by design, each with its reason in the model's notes
    assert {k for k, e in model.locks.items() if e.get("long_held")} == {
        "launch_lock.lock", "_ShapeGate._cond"}
    assert all(len(e) == 3 and e[2].strip() for e in model.order_runtime)


def test_concurrency_rules_are_clean_on_the_port(package_findings):
    conc = [f for f in package_findings if f.rule in CONC]
    assert conc == [], "\n".join(f.render() for f in conc)


def _conc_run(tmp_path, rel, old, new, rule):
    """``rule`` over a copy of the port in ``tmp_path`` with one edit to
    the module ``rel``."""
    from llm_weighted_consensus_tpu_torch.analysis.engine import (
        source_files,
    )

    files = []
    for src in source_files():
        dst = tmp_path / src.resolve().relative_to(REPO)
        dst.parent.mkdir(parents=True, exist_ok=True)
        text = src.read_text()
        if dst == tmp_path / rel:
            assert old in text, f"mutation anchor drifted in {rel}"
            text = text.replace(old, new)
        dst.write_text(text)
        files.append(dst)
    return run_lint(paths=files, rules=[RULES_BY_NAME[rule]],
                    rel_to=tmp_path)


def test_lwc014_catches_an_unregistered_function_lock(tmp_path):
    findings = [f for f in _conc_run(
        tmp_path, "llm_weighted_consensus_tpu_torch/serve/lifecycle.py",
        "        self._drain: Optional[Future] = None\n",
        "        self._drain: Optional[Future] = None\n\n"
        "    def rogue(self):\n        lk = threading.Lock()\n"
        "        return lk\n", "LWC014")
        if "not in the lock-model registry" in f.message]
    assert len(findings) == 1
    assert "Lifecycle.rogue.lk" in findings[0].message


def test_lwc016_catches_a_device_wait_under_the_batcher_condition(tmp_path):
    findings = _conc_run(
        tmp_path, "llm_weighted_consensus_tpu_torch/serve/batcher.py",
        "    def _embed_cache_stats(self) -> dict:\n"
        "        with self._embed_lock:\n",
        "    def _embed_cache_stats(self) -> dict:\n"
        "        with self._cond:\n"
        "            _seam.wait_device_ready(None)\n"
        "        with self._embed_lock:\n", "LWC016")
    assert [f.symbol for f in findings] == [
        "DeviceBatcher._embed_cache_stats"]
    assert "wait_device_ready" in findings[0].message


# -- the CLI ----------------------------------------------------------------------


def test_cli_exit_codes(tmp_path, capsys):
    from llm_weighted_consensus_tpu_torch.analysis.__main__ import main

    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"suppressions": []}))
    base = ["--no-jaxpr", "--no-mesh", "--baseline", str(empty)]
    assert main([str(FIXTURES / "lwc002_good.py"), *base]) == 0
    assert main([str(FIXTURES / "lwc002_bad.py"), *base]) == 1
    assert "LWC002" in capsys.readouterr().out
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"suppressions": [
        {"rule": "LWC001", "path": "gone.py", "symbol": None,
         "reason": "covered code was deleted"}]}))
    assert main([str(FIXTURES / "lwc002_good.py"), "--no-jaxpr",
                 "--no-mesh", "--baseline", str(stale)]) == 2
    reasonless = tmp_path / "reasonless.json"
    reasonless.write_text(json.dumps({"suppressions": [
        {"rule": "LWC001", "path": "gone.py", "symbol": None}]}))
    assert main([str(FIXTURES / "lwc002_good.py"), "--no-jaxpr",
                 "--baseline", str(reasonless)]) == 2
    assert main(["--rules", "LWC999"]) == 2


def test_cli_says_the_mesh_audit_waits(tmp_path, capsys, monkeypatch):
    from llm_weighted_consensus_tpu_torch.analysis.__main__ import main

    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"suppressions": []}))
    monkeypatch.setenv("ANALYSIS_MESH_DP", "4")
    assert main([str(FIXTURES / "lwc002_good.py"), "--no-jaxpr", "--json",
                 "--baseline", str(empty)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["mesh"]["run"] is False and not out["mesh"]["skipped"]
    assert "item 9" in out["mesh"]["reason"]
    assert out["mesh"]["knobs_set"] == ["ANALYSIS_MESH_DP"]
    assert out["audit_run"] is False


def test_lint_alone_leaves_torch_unimported():
    probe = (
        "import json, sys\n"
        "from llm_weighted_consensus_tpu_torch.analysis.__main__ import main\n"
        "rc = main(['--no-jaxpr', '--json'])\n"
        "print(json.dumps({'rc': rc, 'torch': 'torch' in sys.modules}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                          text=True, cwd=str(REPO), timeout=300,
                          env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    report = json.loads(lines[-2])
    assert report["findings"] == [] and report["stale_baseline"] == []
    assert json.loads(lines[-1]) == {"rc": 0, "torch": False}


def test_cli_module_exits_zero_on_the_tree():
    """``python -m llm_weighted_consensus_tpu_torch.analysis`` — lint,
    concurrency audit and the dispatch audit's CPU half — exits 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "llm_weighted_consensus_tpu_torch.analysis",
         "--json"],
        capture_output=True, text=True, cwd=str(REPO), timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["findings"] == [] and payload["audit_run"] is True
    assert len(payload["suppressed"]) == len(load_baseline())
