"""The mesh audit: sharding, collective plan and resource envelope of the
serving path over a mesh (JXA006-013).

The port's counterpart of ``llm_weighted_consensus_tpu/analysis/
mesh_audit.py``.  The reference lowers its serving executables under a
simulated 8-device mesh and reads XLA's HLO, ``memory_analysis`` and
``cost_analysis``; the port has no lowered program, so it audits what
the mesh really runs.  It builds the mesh embedder as
``serve/__main__.py`` does (``shard_embedder_mesh`` and ``warmup``) over
``[torch.device("cpu")] * 8`` (one process drives every shard, so no
subprocess and no virtual devices are needed), drives each warmed
bucket through the embedder's public dispatch, and records the
collectives it forms (``parallel.collectives.recording``) and the aten
ops it runs (``dispatch_audit.recording``):

* **JXA006 rule coverage**: over the port's tensors of the big presets
  (bge-large-en and deberta-v3-base, full precision and int8, on the
  meta device), every reference leaf matches exactly one partition rule
  and every rule at least one leaf (``sharding.match_report``);
* **JXA007 oversized replication**: a leaf (its layers' tensors summed,
  as the reference's stacked leaf) above ``replicated_threshold_bytes``
  that no rule splits needs a ``replicated_allowlist`` entry in
  ``analysis/budgets.json``;
* **JXA008 collective plan**: per dispatch, two tp reductions per layer
  per dp row and forward (``psum`` over ``tp``; the reward model adds its
  head's), every tp group inside one dp row, the ring's rotation
  (``ppermute`` over ``sp``) on a ring bucket, no all-to-all, and no host
  copy inside the dispatch (an aten op that reads a device value on the
  host, ``dispatch_audit.HOST_SYNC_OPS``, outside the kernel wrappers);
  a bucket that was not warmed is a finding too;
* **JXA009/JXA010 resource budgets**: one shard's ``hbm_bytes`` (its
  parameter bytes plus its argument and output bytes), ``flops`` and
  ``bytes_accessed`` (``cost.shard_cost``) against the committed
  ``analysis/budgets.json`` (``budgets.py``);
* **JXA011 numerical equivalence**: each warmed bucket through the
  public dispatch against a same-seed one-device embedder, 1e-4, with
  the graph table's bracket (no capture and no eager dispatch across the
  audited dispatches);
* **JXA012 fault-ladder coverage**: after ``MeshFaultManager.
  warm_ladder`` every rung holds every bucket, and each downsized rung
  passes the JXA011 gate; on the dense mesh and on the sp mesh (dp
  halves, tp and sp kept);
* **JXA013 roofline coverage**: every audited serving bucket has a row
  in ``analysis/roofline.json``, and the file holds a fresh count of its
  scope (``roofline.compare_roofline``).  ``reward_packed`` is audited
  for JXA008-011 but is no serving label of the port (its reranker serves
  ``rm(...)`` buckets), so it has no roofline row.

The sp mesh folds sp out of dp (``dp//sp x tp x sp``, 2x2x2 by default),
so both meshes use ``dp*tp`` devices.

Env knobs (the reference's, all optional): ``ANALYSIS_MESH_MODEL``
(default ``test-tiny``), ``ANALYSIS_MESH_DP`` / ``ANALYSIS_MESH_TP``
(default 4x2), ``ANALYSIS_MESH_SP`` (default 2; 1 disables the ring
audit), ``ANALYSIS_MESH_SPECS`` (default ``8x16``),
``ANALYSIS_MESH_R_BUCKETS`` (default ``2``),
``ANALYSIS_MESH_PACKED_BUCKETS`` (default ``8x64x8``),
``ANALYSIS_MESH_RING_BUCKETS`` (default ``2x64``; empty disables the
ring audit), ``ANALYSIS_BUDGETS``, ``ANALYSIS_ROOFLINE``;
``ANALYSIS_SKIP_MESH=1`` skips it (the CLI honours it).

Re-baselining: ``python -m llm_weighted_consensus_tpu_torch.analysis.
mesh_audit --write-budgets`` re-measures and rewrites ``budgets.json``
(tolerance, threshold and allowlist kept); review the diff.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path
from typing import Dict, List, Sequence, Set, Tuple

from .budgets import (
    allowlisted,
    check_allowlist_stale,
    compare_budgets,
    default_budgets_path,
    load_budgets,
    replicated_allowlist,
    replicated_threshold,
)
from .engine import Finding

_DEFAULT_MODEL = "test-tiny"
_DEFAULT_RM_MODEL = "deberta-test-tiny"
_DEFAULT_DP, _DEFAULT_TP = 4, 2
_DEFAULT_SPECS = ((8, 16),)
_DEFAULT_R_BUCKETS = (2,)
_DEFAULT_PACKED_BUCKETS = ((8, 64, 8),)
_DEFAULT_SP = 2
_DEFAULT_RING_BUCKETS = ((2, 64),)

# the big trees: where an accidentally replicated table costs real memory
_COVERAGE_PRESETS = ("bge-large-en",)
_COVERAGE_RM_PRESETS = ("deberta-v3-base",)

# collectives the serving path must never form
FORBIDDEN_COLLECTIVES = ("all_to_all",)
ATOL = 1e-4
CLI = "python -m llm_weighted_consensus_tpu_torch.analysis.mesh_audit"


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    return int(raw) if raw.strip() else default


def _env_mesh() -> Tuple[int, int]:
    return (
        _env_int("ANALYSIS_MESH_DP", _DEFAULT_DP),
        _env_int("ANALYSIS_MESH_TP", _DEFAULT_TP),
    )


def _env_model() -> str:
    return os.environ.get("ANALYSIS_MESH_MODEL", "") or _DEFAULT_MODEL


def _parse_specs(raw: str) -> tuple:
    return tuple(
        tuple(int(x) for x in part.strip().lower().split("x"))
        for part in raw.split(",") if part.strip()
    )


def _env_specs() -> Tuple[Tuple[int, int], ...]:
    raw = os.environ.get("ANALYSIS_MESH_SPECS", "")
    return _parse_specs(raw) if raw.strip() else _DEFAULT_SPECS


def _env_r_buckets() -> Tuple[int, ...]:
    raw = os.environ.get("ANALYSIS_MESH_R_BUCKETS", "")
    if not raw.strip():
        return _DEFAULT_R_BUCKETS
    return tuple(int(p) for p in raw.split(",") if p.strip())


def _env_packed_buckets() -> Tuple[Tuple[int, int, int], ...]:
    raw = os.environ.get("ANALYSIS_MESH_PACKED_BUCKETS")
    if raw is None or not raw.strip():
        return _DEFAULT_PACKED_BUCKETS
    return _parse_specs(raw)


def _env_sp() -> int:
    return _env_int("ANALYSIS_MESH_SP", _DEFAULT_SP)


def _env_ring_buckets() -> Tuple[Tuple[int, int], ...]:
    """``NxS`` ring buckets; an explicitly empty value disables the ring
    audit."""
    raw = os.environ.get("ANALYSIS_MESH_RING_BUCKETS")
    return _DEFAULT_RING_BUCKETS if raw is None else _parse_specs(raw)


def _ring_enabled() -> bool:
    dp, _tp = _env_mesh()
    sp = _env_sp()
    return bool(_env_ring_buckets()) and sp > 1 and dp % sp == 0


def _budgets_path() -> Path:
    raw = os.environ.get("ANALYSIS_BUDGETS", "")
    return Path(raw) if raw.strip() else default_budgets_path()


def _roofline_path() -> Path:
    from .roofline import default_roofline_path

    raw = os.environ.get("ANALYSIS_ROOFLINE", "")
    return Path(raw) if raw.strip() else default_roofline_path()


def _scope() -> dict:
    dp, tp = _env_mesh()
    return {
        "model": _env_model(),
        "rm_model": _DEFAULT_RM_MODEL,
        "dp": dp,
        "tp": tp,
        "specs": ["x".join(map(str, s)) for s in _env_specs()],
        "r_buckets": list(_env_r_buckets()),
        "packed_buckets": ["x".join(map(str, b))
                           for b in _env_packed_buckets()],
        "sp": _env_sp(),
        "ring_buckets": ["x".join(map(str, b)) for b in _env_ring_buckets()],
    }


def _finding(rule: str, label: str, message: str, symbol=None) -> Finding:
    return Finding(rule=rule, path=f"mesh:{label}", line=0, message=message,
                   symbol=symbol)


# ---------------------------------------------------------------------------
# JXA006/JXA007: partition-rule coverage and replication policy
# ---------------------------------------------------------------------------


def audit_rule_coverage(rules, tree, label: str) -> List[Finding]:
    """JXA006: every leaf exactly one rule; every rule at least one leaf.
    ``tree`` is a model or a state dict of the port's tensors."""
    from ..parallel.sharding import match_report

    findings: List[Finding] = []
    leaf_matches, rule_counts = match_report(rules, tree)
    for path, hits in sorted(leaf_matches.items()):
        if not hits:
            findings.append(_finding(
                "JXA006", label,
                f"param leaf `{path}` matches NO partition rule: it would "
                "be placed whole on every shard without a decision — add a "
                "rule (or fix the pattern)", path))
        elif len(hits) > 1:
            findings.append(_finding(
                "JXA006", label,
                f"param leaf `{path}` matches {len(hits)} rules "
                f"({', '.join(hits)}): ambiguous — first-match-wins hides "
                "whichever layout lost", path))
    for name, count in rule_counts.items():
        if count == 0:
            findings.append(_finding(
                "JXA006", label,
                f"partition rule `{name}` matches no param leaf: a dead "
                "rule is a layout decision nobody audits — delete it or "
                "fix its pattern", name))
    return findings


def _leaf_sizes(tree) -> Dict[str, tuple]:
    """{reference leaf path: (bytes, shape, dtype, one port name)}, the
    port's per-layer tensors of a stacked leaf summed (its shape gains a
    leading layer count)."""
    from ..parallel.sharding import tree_path_leaves

    out: Dict[str, list] = {}
    for path, name, t in tree_path_leaves(tree):
        size = int(t.element_size()) * int(t.nelement())
        if path in out:
            entry = out[path]
            entry[0] += size
            entry[1] = (entry[1][0] + 1,) + tuple(t.shape)
        else:
            out[path] = [size, (1,) + tuple(t.shape), t.dtype, name]
    return {p: (e[0], e[1][1:] if e[1][0] == 1 else e[1], e[2], e[3])
            for p, e in out.items()}


def audit_replication(rules, tree, label: str, threshold_bytes: int,
                      allowlist: Sequence[dict]) -> Tuple[List[Finding],
                                                          Set[str]]:
    """JXA007: no leaf above the size threshold replicated across the
    mesh without an allowlist entry.  Returns the findings and the
    allowlist patterns that earned their keep."""
    from ..parallel.sharding import match_partition_rules

    findings: List[Finding] = []
    matched: Set[str] = set()
    try:
        specs = match_partition_rules(rules, tree)
    except ValueError:
        return findings, matched  # JXA006 owns uncovered leaves
    for path, (size, shape, dtype, name) in sorted(_leaf_sizes(tree).items()):
        if size <= threshold_bytes:
            continue
        if any(axis is not None for axis in specs[name]):
            continue  # split somewhere: not replicated
        pattern = allowlisted(path, allowlist)
        if pattern is not None:
            matched.add(pattern)
            continue
        findings.append(_finding(
            "JXA007", label,
            f"`{path}` ({size} bytes, {'x'.join(map(str, shape))} "
            f"{str(dtype).replace('torch.', '')}) is fully replicated and "
            f"above the {threshold_bytes}-byte threshold: shard it or add "
            "a replicated_allowlist entry with a reason to "
            "analysis/budgets.json", path))
    return findings, matched


def _shape_trees() -> list:
    """(label, rules, model on the meta device) for every audited layout:
    the big presets, full precision and int8, bert and deberta."""
    import torch

    from ..models import bert, deberta, quant
    from ..models.configs import PRESETS
    from ..models.reranker import RM_PRESETS
    from ..parallel.sharding import (
        bert_partition_rules,
        deberta_partition_rules,
    )

    out = []
    for preset in _COVERAGE_PRESETS:
        for q in (False, True):
            with torch.device("meta"):
                model = bert.BertEncoder(PRESETS[preset])
                if q:
                    quant.quantize_encoder(model, "int8")
            out.append((f"bert:{preset}" + (":int8" if q else ""),
                        bert_partition_rules(quantized=q), model))
    for preset in _COVERAGE_RM_PRESETS:
        for q in (False, True):
            with torch.device("meta"):
                model = deberta.DebertaModel(RM_PRESETS[preset])
                if q:
                    quant.quantize_encoder(model, "int8")
            out.append((f"deberta:{preset}" + (":int8" if q else ""),
                        deberta_partition_rules(quantized=q), model))
    return out


# ---------------------------------------------------------------------------
# JXA008: the collective plan of one dispatch
# ---------------------------------------------------------------------------


def audit_collectives(notes: list, label: str, *, tp: int, layers: int,
                      dp_rows: int, forwards: int = 1, extra_tp: int = 0,
                      ring: bool = False,
                      forbid: Sequence[str] = FORBIDDEN_COLLECTIVES
                      ) -> List[Finding]:
    """The collectives one dispatch formed (``collectives.recording``
    notes) against the plan: ``2 * layers`` tp reductions per dp row and
    forward (plus ``extra_tp``: the reward head's), each inside one dp
    row; a ring dispatch rotates over sp; no forbidden op."""
    findings: List[Finding] = []
    tp_notes = [n for n in notes if n.get("axis") == "tp"]
    if tp > 1:
        want = 2 * layers * dp_rows * forwards + extra_tp
        got = sum(1 for n in tp_notes if n["op"] == "psum")
        if got != want:
            findings.append(_finding(
                "JXA008", label,
                f"{got} tp reductions (psum over tp) where the Megatron "
                f"layout makes {want} (2 per layer per dp row and forward"
                + (f", plus {extra_tp}" if extra_tp else "") + "): the tp "
                "layout degenerated or gained a collective"))
    for n in tp_notes:
        rows = {m.get("dp", 0) for m in n.get("members", ())}
        if len(rows) > 1:
            findings.append(_finding(
                "JXA008", label,
                f"a tp {n['op']} group spans dp rows {sorted(rows)}: tp "
                "reductions must stay inside one dp row's shards"))
            break
    if ring and not any(n["op"] == "ppermute" and n.get("axis") == "sp"
                        for n in notes):
        findings.append(_finding(
            "JXA008", label,
            "a ring dispatch formed no rotation over sp (ppermute): the "
            "sequence was not split, the ring buys nothing"))
    for n in notes:
        if n["op"] in forbid:
            findings.append(_finding(
                "JXA008", label,
                f"forbidden collective `{n['op']}` inside the serving "
                "dispatch: an all-to-all reshards mid-forward"))
            break
    return findings


def audit_host_copies(rec, label: str) -> List[Finding]:
    """JXA008's host-transfer half: no aten op that reads a device value
    on the host outside the kernel wrappers (``dispatch_audit``)."""
    from .dispatch_audit import HOST_SYNC_OPS

    syncs = sorted({op.name for op in rec.ops
                    if not op.in_wrapper and op.name in HOST_SYNC_OPS})
    if not syncs:
        return []
    return [_finding(
        "JXA008", label,
        f"host transfer inside the serving dispatch ({', '.join(syncs)}): "
        "a device value read on the host stalls the whole mesh")]


def _missing(label: str, key) -> Finding:
    return _finding(
        "JXA008", label,
        f"no warmed bucket at serving key {key}: warmup did not cover it, "
        "so mesh traffic at this bucket would run eager mid-request")


# ---------------------------------------------------------------------------
# JXA008-011: every warmed bucket, through the public dispatch
# ---------------------------------------------------------------------------


def _packed_inputs(rng, vocab: int, b: int, l: int, k: int):
    import numpy as np

    pids = np.zeros((b, l), np.int32)
    pseg = np.zeros((b, l), np.int32)
    ppos = np.zeros((b, l), np.int32)
    pstarts = np.zeros((b, k), np.int32)
    for row in range(b):
        n0, n1 = 5 + row % 3, 3
        pids[row, : n0 + n1] = rng.integers(3, vocab, n0 + n1)
        pseg[row, :n0] = 1
        pseg[row, n0: n0 + n1] = 2
        ppos[row, :n0] = np.arange(n0)
        ppos[row, n0: n0 + n1] = np.arange(n1)
        pstarts[row, 1] = n0
    return pids, pseg, ppos, pstarts


def _param_bytes(module) -> int:
    return sum(int(t.element_size()) * int(t.nelement())
               for t in module.state_dict().values())


def _figures(config, label: str, dp: int, tp: int, sp: int, params: int,
             args: int, outputs: int) -> Dict[str, float]:
    """One shard's budget figures: ``hbm_bytes`` (parameters, arguments,
    outputs) and ``cost.shard_cost``'s flops and bytes."""
    from .cost import shard_cost

    out = {"hbm_bytes": float(params + args + outputs)}
    out.update(shard_cost(config, label, dp, tp, sp, dtype_bytes=4))
    return out


class _Bracket:
    """The graph table's counters across a block of dispatches: no
    capture and no eager dispatch may happen after warmup."""

    def __init__(self, embedder) -> None:
        self.embedder = embedder
        self.before = self._now()

    def _now(self) -> dict:
        stats = self.embedder.graph_stats()
        return {"captures": stats["captures"],
                "eager_dispatches": stats["eager_dispatches"]}

    def grew(self) -> dict:
        after = self._now()
        return {k: f"{self.before[k]}->{v}" for k, v in after.items()
                if v > self.before[k]}


def _check(findings, rule, label, got, want, what="mesh dispatch") -> None:
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.allclose(got, want, atol=ATOL,
                                                  rtol=1e-4):
        worst = (float(np.max(np.abs(got - want)))
                 if got.shape == want.shape else float("inf"))
        findings.append(_finding(
            rule, label,
            f"{what} diverges from the single-device reference (max abs "
            f"diff {worst:.2e} > {ATOL}): the partition plan changed the "
            "math, not just the layout"))


def _audited(fn):
    """Run ``fn()`` recording its collectives and its aten ops -> (value,
    notes, op recording)."""
    from ..parallel import collectives
    from .dispatch_audit import recording

    with collectives.recording() as notes, recording() as rec:
        value = fn()
    return value, notes, rec


def _make_embedder(model: str, mesh=None):
    from ..models.embedder import TorchEmbedder
    from ..parallel.sharding import shard_embedder_mesh

    embedder = TorchEmbedder(model, max_tokens=64, seed=0, device="cpu")
    if mesh is not None:
        shard_embedder_mesh(embedder, mesh)
    return embedder


def _cpu_mesh(dp: int, tp: int, sp: int = 1):
    import torch

    from ..parallel.mesh import make_mesh

    return make_mesh(dp=dp, tp=tp, sp=sp,
                     devices=[torch.device("cpu")] * (dp * tp * sp))


def _dense_cases(embedder, ref, specs, r_buckets, packed_buckets, rng):
    """[(kind, label, key, inputs, reference output)], the reference
    dispatched first."""
    import numpy as np

    from ..models.embedder import _bucket, _seq_bucket

    bm = embedder.batch_multiple
    vocab = embedder.config.vocab_size
    cases = []
    for n, s in specs:
        s = _seq_bucket(s, embedder.max_tokens)
        ids = rng.integers(3, vocab, (n, s)).astype(np.int32)
        mask = np.ones((n, s), np.int32)
        cases.append(("vote1", f"vote1(n={n},s={s})", ("vote1", n, s),
                      (ids, mask),
                      ref.consensus_confidence_tokens(ids, mask, 1.0)))
        pad_b = _bucket(n, embedder.MAX_DEVICE_BATCH)
        pad_b += (-pad_b) % bm
        bids = rng.integers(3, vocab, (pad_b, s)).astype(np.int32)
        bmask = np.ones((pad_b, s), np.int32)
        cases.append(("embed", f"embed(b={pad_b},s={s})",
                      ("embed", pad_b, s), (bids, bmask),
                      ref.embed_tokens(bids, bmask)))
        for r in r_buckets:
            if r < 2:
                continue
            gids = rng.integers(3, vocab, (r, n, s)).astype(np.int32)
            gmask = np.ones((r, n, s), np.int32)
            cases.append(("many", f"many(r={r},n={n},s={s})",
                          ("many", r, n, s), (gids, gmask),
                          ref.consensus_confidence_tokens_many(
                              gids, gmask, 1.0)))
    for b, l, k in packed_buckets:
        args = _packed_inputs(rng, vocab, b, l, k)
        pb = b + (-b) % bm  # the dispatch pads rows to the dp multiple
        cases.append(("packed", f"packed(b={pb},l={l},k={k})",
                      ("packed", pb, l, k), args, ref.embed_packed(*args)))
    return cases


def _dispatch(embedder, kind, args):
    if kind == "vote1":
        return embedder.consensus_confidence_tokens(*args, 1.0)
    if kind == "embed":
        return embedder.embed_tokens(*args)
    if kind == "many":
        return embedder.consensus_confidence_tokens_many(*args, 1.0)
    if kind == "packed":
        return embedder.embed_packed(*args)
    if kind == "ring_vote":
        return embedder.consensus_confidence_tokens_ring(*args, 1.0)
    return embedder.embed_tokens_ring(*args)


def _dense_figures(embedder, label, kind, args, dp, tp) -> dict:
    """One shard's budget figures for a dense bucket."""
    h = embedder.config.hidden_size
    shard = embedder.mesh_model.shard(0, embedder.mesh.device())
    rows = args[0].shape[0] * (args[0].shape[1] if kind == "many" else 1)
    rows = (rows + (-rows) % dp) // dp
    seq = args[0].shape[-1]
    if kind == "packed":
        k = args[3].shape[1]
        arg_bytes = rows * seq * 4 * 3 + rows * k * 4
        out_bytes = rows * k * h * 4
    else:
        arg_bytes = rows * seq * 4 * 2
        out_bytes = rows * (h if kind == "embed" else 1) * 4
    return _figures(embedder.config, label, dp, tp, 1, _param_bytes(shard),
                    arg_bytes, out_bytes)


def audit_serving_buckets(embedder, ref, specs, r_buckets, packed_buckets
                          ) -> Tuple[List[Finding], Dict[str, dict]]:
    """JXA008-011 over a warmed mesh embedder's buckets (module doc)."""
    import numpy as np

    findings: List[Finding] = []
    measured: Dict[str, dict] = {}
    dp, tp = embedder.mesh_shape
    layers = embedder.config.num_layers
    cases = _dense_cases(embedder, ref, specs, r_buckets, packed_buckets,
                         np.random.default_rng(0))
    bracket = _Bracket(embedder)
    for kind, label, key, args, want in cases:
        if not embedder.has_bucket(key):
            findings.append(_missing(label, key))
        got, notes, rec = _audited(lambda: _dispatch(embedder, kind, args))
        findings += audit_collectives(notes, label, tp=tp, layers=layers,
                                      dp_rows=dp)
        findings += audit_host_copies(rec, label)
        measured[label] = _dense_figures(embedder, label, kind, args, dp, tp)
        _check(findings, "JXA011", label, got, want)
    grew = bracket.grew()
    if grew:
        findings.append(_finding(
            "JXA008", "dispatch",
            f"mesh dispatches captured or ran eager after warmup ({grew}): "
            "the audited buckets describe graphs that served no traffic"))
    return findings, measured


def _ring_cases(embedder, ref, ring_buckets, rng):
    import numpy as np

    from ..models.embedder import _bucket, _seq_bucket

    sp, bm = embedder.mesh_sp, embedder.batch_multiple
    vocab = embedder.config.vocab_size
    cases = []
    for n, s in ring_buckets:
        s = _seq_bucket(s, embedder.ring_max_tokens)
        s = min(s + (-s) % sp, embedder.ring_max_tokens)
        ids = rng.integers(3, vocab, (n, s)).astype(np.int32)
        mask = np.ones((n, s), np.int32)
        cases.append(("ring_vote", f"ring_vote(n={n},s={s})",
                      ("ring_vote", n, s), (ids, mask),
                      ref.consensus_confidence_tokens(ids, mask, 1.0)))
        pad_b = _bucket(n, embedder.MAX_DEVICE_BATCH)
        pad_b += (-pad_b) % bm
        bids = rng.integers(3, vocab, (pad_b, s)).astype(np.int32)
        bmask = np.ones((pad_b, s), np.int32)
        cases.append(("ring", f"ring(b={pad_b},s={s})", ("ring", pad_b, s),
                      (bids, bmask), ref.embed_tokens(bids, bmask)))
    return cases


def audit_ring_buckets(embedder, ref, ring_buckets
                       ) -> Tuple[List[Finding], Dict[str, dict]]:
    """JXA008-011 over the ring buckets of a warmed sp-mesh embedder:
    ring against the one-device dense forward."""
    import numpy as np

    findings: List[Finding] = []
    measured: Dict[str, dict] = {}
    dp, tp = embedder.mesh_shape
    sp = embedder.mesh_sp
    h = embedder.config.hidden_size
    full = embedder.mesh_model.full(embedder.mesh.device())
    bracket = _Bracket(embedder)
    for kind, label, key, args, want in _ring_cases(
            embedder, ref, ring_buckets, np.random.default_rng(3)):
        if not embedder.has_ring_bucket(key):
            findings.append(_missing(label, key))
        got, notes, rec = _audited(lambda: _dispatch(embedder, kind, args))
        findings += audit_collectives(notes, label, tp=1, layers=0,
                                      dp_rows=dp, ring=True)
        findings += audit_host_copies(rec, label)
        rows = args[0].shape[0] // dp
        s_loc = args[0].shape[1] // sp
        measured[label] = _figures(
            embedder.config, label, dp, tp, sp, _param_bytes(full),
            rows * s_loc * 4 * 2,
            rows * (h if kind == "ring" else 1) * 4)
        _check(findings, "JXA011", label, got, want, "ring dispatch")
    grew = bracket.grew()
    if grew:
        findings.append(_finding(
            "JXA008", "ring-dispatch",
            f"ring dispatches captured or ran eager after warmup ({grew})"))
    return findings, measured


def reward_packed_mesh(placed, ids, segment_ids, seg_starts):
    """``deberta.reward_packed`` over a mesh: the packed rows over dp, the
    layers and the head tensor-parallel -> [b, k] f32 on the mesh's
    first device."""
    import torch

    from ..models import bert, deberta

    def body(model, part, tp):
        seg = part["seg"]
        hidden = yield from deberta.encode_steps(
            model, part["ids"], (seg > 0).int(), segment_ids=seg, tp=tp)
        cls = torch.take_along_dim(
            hidden, part["starts"].long()[:, :, None], dim=1).float()
        return (yield from deberta._head_steps(model, cls, tp=tp))

    parts = bert._mesh_encode(placed, {"ids": ids, "seg": segment_ids,
                                       "starts": seg_starts}, body)
    return torch.cat([p.to(placed.mesh.device()) for p in parts])


def audit_reward_packed(mesh, packed_buckets
                        ) -> Tuple[List[Finding], Dict[str, dict]]:
    """The reward model's packed forward under the DeBERTa rule table,
    its rows over dp: JXA008-011 (only the used slots 0..1 are defined
    output)."""
    import numpy as np
    import torch

    from ..models import deberta
    from ..models.reranker import RM_PRESETS
    from ..parallel.sharding import deberta_partition_rules, shard_by_rules

    findings: List[Finding] = []
    measured: Dict[str, dict] = {}
    config = RM_PRESETS[_DEFAULT_RM_MODEL]
    model = deberta.init_params(config, seed=1, device="cpu")
    placed = shard_by_rules(model, mesh, deberta_partition_rules())
    dp, tp = mesh.shape["dp"], mesh.shape.get("tp", 1)
    rng = np.random.default_rng(0)
    for b, l, k in packed_buckets:
        pids, pseg, _ppos, pstarts = _packed_inputs(rng, config.vocab_size,
                                                    b, l, k)
        label = f"reward_packed(b={b},l={l},k={k})"
        args = [torch.from_numpy(a) for a in (pids, pseg, pstarts)]
        with torch.inference_mode():
            want = deberta.reward_packed(model, *args)
            got, notes, rec = _audited(
                lambda: reward_packed_mesh(placed, *args))
        findings += audit_collectives(notes, label, tp=tp,
                                      layers=config.num_layers,
                                      dp_rows=dp, extra_tp=dp)
        findings += audit_host_copies(rec, label)
        rows = b // dp
        measured[label] = _figures(
            config, label, dp, tp, 1,
            _param_bytes(placed.shard(0, mesh.device())),
            rows * l * 4 * 2 + rows * k * 4, rows * k * 4)
        _check(findings, "JXA011", label, got[:, :2].numpy(),
               want[:, :2].numpy(), "sharded reward output")
    return findings, measured


# ---------------------------------------------------------------------------
# JXA012: the fault ladder
# ---------------------------------------------------------------------------


def _ladder_findings(manager, embedder, cases, keys, label_of, dispatch,
                     has) -> List[Finding]:
    """Walk ``manager``'s ladder: on each downsized rung every key of
    ``keys()`` warmed (``has``), every case's dispatch at the one-device
    answer, and no capture or eager dispatch."""
    findings: List[Finding] = []
    for rung_dp, rung_tp in manager.build_ladder()[1:]:
        label = label_of(rung_dp, rung_tp)
        if not manager.downsize():
            findings.append(_finding(
                "JXA012", label,
                "downsize() refused a declared ladder rung: the ladder the "
                "manager walks is not the ladder it declared"))
            break
        for key in keys():
            if not has(key):
                findings.append(_finding(
                    "JXA012", label,
                    f"no warmed bucket at fallback-rung key {key}: "
                    "warm_ladder did not cover it, so a downsize to "
                    f"{rung_dp}x{rung_tp} would capture under fire"))
        bracket = _Bracket(embedder)
        for args, want in cases:
            _check(findings, "JXA012", label, dispatch(args), want,
                   "degraded-rung dispatch")
        grew = bracket.grew()
        if grew:
            findings.append(_finding(
                "JXA012", label,
                f"rung dispatches captured or ran eager ({grew})"))
    return findings


def audit_fault_ladder(model, dp, tp, specs, r_buckets, packed_buckets
                       ) -> List[Finding]:
    """JXA012 on the dense mesh (module doc)."""
    import numpy as np

    from ..models.embedder import _bucket, _seq_bucket
    from ..resilience import MeshFaultManager

    ref = _make_embedder(model)
    embedder = _make_embedder(model, _cpu_mesh(dp, tp))
    manager = MeshFaultManager(embedder, shape=(dp, tp))
    r2 = [r for r in r_buckets if r >= 2]
    manager.warm_ladder(list(specs), r2, list(packed_buckets))
    rng = np.random.default_rng(0)
    vocab = embedder.config.vocab_size
    cases = []
    for n, s in specs:
        s = _seq_bucket(s, embedder.max_tokens)
        ids = rng.integers(3, vocab, (n, s)).astype(np.int32)
        mask = np.ones((n, s), np.int32)
        cases.append(((ids, mask), ref.consensus_confidence_tokens(ids,
                                                                  mask)))

    def keys():
        bm = embedder.batch_multiple
        out = []
        for n, s in specs:
            s = _seq_bucket(s, embedder.max_tokens)
            pad_b = _bucket(n, embedder.MAX_DEVICE_BATCH)
            out += [("vote1", n, s), ("embed", pad_b + (-pad_b) % bm, s)]
            out += [("many", r, n, s) for r in r2]
        out += [("packed", b + (-b) % bm, l, k)
                for b, l, k in packed_buckets]
        return out

    return _ladder_findings(
        manager, embedder, cases, keys,
        lambda d, t: f"ladder:{d}x{t}",
        lambda a: embedder.consensus_confidence_tokens(*a),
        embedder.has_bucket)


def audit_ring_fault_ladder(model, dp, tp, sp, ring_buckets
                            ) -> List[Finding]:
    """JXA012 on the sp mesh: dp halves, tp and sp kept, the ring buckets
    warmed per rung and answering as the one-device dense forward."""
    import numpy as np

    from ..resilience import MeshFaultManager

    rdp = dp // sp
    if rdp < 2:
        return []  # no rung below the full shape
    ref = _make_embedder(model)
    embedder = _make_embedder(model, _cpu_mesh(rdp, tp, sp))
    manager = MeshFaultManager(embedder, shape=(rdp, tp))
    manager.warm_ladder([], ring_buckets=list(ring_buckets))
    cases = [(args, want) for kind, _l, _k, args, want in _ring_cases(
        embedder, ref, ring_buckets, np.random.default_rng(5))
        if kind == "ring_vote"]
    keys = [key for _kind, _l, key, _a, _w in _ring_cases(
        embedder, ref, ring_buckets, np.random.default_rng(5))
        if key[0] == "ring_vote"]
    return _ladder_findings(
        manager, embedder, cases, lambda: keys,
        lambda d, t: f"ring-ladder:{d}x{t}x{sp}",
        lambda a: embedder.consensus_confidence_tokens_ring(*a),
        embedder.has_ring_bucket)


# ---------------------------------------------------------------------------
# JXA013 and the orchestration
# ---------------------------------------------------------------------------


def audit_roofline(measured: Dict[str, dict], roofline: dict
                   ) -> List[Finding]:
    """JXA013: a roofline row for every audited serving bucket, and the
    file a fresh count of its own scope."""
    from .roofline import compare_roofline, measure

    if not roofline:
        return compare_roofline({}, roofline)
    findings = list(compare_roofline(measure(roofline["scope"]), roofline,
                                     roofline["scope"]))
    rows = roofline.get("buckets", {})
    for label in sorted(measured):
        if label.startswith("reward_packed(") or label in rows:
            continue
        findings.append(Finding(
            rule="JXA013", path="analysis/roofline.json", line=0,
            symbol=label,
            message=(f"audited bucket `{label}` has no roofline row: it "
                     "would serve without an attainment gauge — add its "
                     "shape to the roofline's scope (mesh_audit) and "
                     "re-write the file")))
    return findings


def audit_in_process(write_budgets: bool = False
                     ) -> Tuple[List[Finding], Dict[str, dict]]:
    import torch

    from .roofline import load_roofline

    findings: List[Finding] = []
    budgets_path = _budgets_path()
    budgets = load_budgets(budgets_path)
    allowlist = replicated_allowlist(budgets)
    threshold = replicated_threshold(budgets)
    matched: Set[str] = set()
    for label, rules, tree in _shape_trees():
        findings += audit_rule_coverage(rules, tree, label)
        repl, hits = audit_replication(rules, tree, label, threshold,
                                       allowlist)
        findings += repl
        matched |= hits
    findings += check_allowlist_stale(allowlist, matched)

    dp, tp = _env_mesh()
    model = _env_model()
    specs, r_buckets = _env_specs(), _env_r_buckets()
    packed = _env_packed_buckets()
    with torch.inference_mode():
        mesh = _cpu_mesh(dp, tp)
        ref = _make_embedder(model)
        embedder = _make_embedder(model, mesh)
        embedder.warmup(list(specs), [r for r in r_buckets if r >= 2],
                        list(packed))
        got, measured = audit_serving_buckets(embedder, ref, specs,
                                              r_buckets, packed)
        findings += got
        got, rm = audit_reward_packed(mesh, packed)
        findings += got
        measured.update(rm)
        findings += audit_fault_ladder(model, dp, tp, specs, r_buckets,
                                       packed)
        if _ring_enabled():
            sp = _env_sp()
            ring = _make_embedder(model, _cpu_mesh(dp // sp, tp, sp))
            ring.warmup([], ring_buckets=list(_env_ring_buckets()))
            got, ring_measured = audit_ring_buckets(ring, ref,
                                                    _env_ring_buckets())
            findings += got
            measured.update(ring_measured)
            findings += audit_ring_fault_ladder(model, dp, tp, sp,
                                                _env_ring_buckets())
    if write_budgets:
        write_budgets_file(budgets_path, measured, budgets)
    else:
        findings += compare_budgets(measured, budgets, scope=_scope())
    findings += audit_roofline(measured, load_roofline(_roofline_path()))
    return findings, measured


def write_budgets_file(path: Path, measured: Dict[str, dict],
                       previous: dict) -> None:
    """Fresh figures under the committed policy knobs (tolerance,
    threshold and allowlist survive a re-baseline; figures do not)."""
    payload = {
        "_doc": (
            "Committed per-bucket resource budgets of one shard for the "
            "port's mesh audit (JXA009/JXA010): hbm_bytes = the shard's "
            "parameter + argument + output bytes, flops and "
            "bytes_accessed = analysis/cost.py's shard_cost. Re-baseline: "
            f"{CLI} --write-budgets, then review the diff."
        ),
        "scope": _scope(),
        "tolerance": previous.get(
            "tolerance",
            {"hbm_bytes": 0.25, "flops": 0.25, "bytes_accessed": 0.25}),
        "replicated_threshold_bytes": previous.get(
            "replicated_threshold_bytes", 1 << 20),
        "replicated_allowlist": previous.get("replicated_allowlist", []),
        "buckets": {
            label: {k: round(v, 1) for k, v in figures.items()}
            for label, figures in sorted(measured.items())
        },
    }
    path.write_text(json.dumps(payload, indent=2) + "\n", encoding="utf-8")


def run_mesh_audit(write_budgets: bool = False) -> List[Finding]:
    """The analysis CLI's entry: the whole audit in this process."""
    return audit_in_process(write_budgets)[0]


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog=CLI, description="the mesh sharding and resource audit "
        "(JXA006-013) over [cpu] * 8")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output")
    parser.add_argument(
        "--write-budgets", action="store_true",
        help="re-measure and rewrite analysis/budgets.json (policy knobs "
        "kept); review the diff")
    args = parser.parse_args(argv)
    findings, measured = audit_in_process(args.write_budgets)
    if args.json:
        print(json.dumps({"findings": [vars(f) for f in findings],
                          "measured": measured, "scope": _scope()}))
    else:
        for finding in findings:
            print(finding.render())
        print(f"mesh audit: {len(findings)} finding(s), {len(measured)} "
              "bucket(s) measured", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
