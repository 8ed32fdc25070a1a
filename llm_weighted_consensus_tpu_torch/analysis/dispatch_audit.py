"""The dispatch audit: the port's counterpart of the reference's jaxpr
audit (``llm_weighted_consensus_tpu/analysis/jaxpr_audit.py``).

The reference traces its jitted serving functions (``jax.make_jaxpr``)
and checks their structure.  Torch has no traced program to walk, so the
port records what one dispatch of each served kind actually runs: every
aten op, with the dtypes of its tensors, under
``torch.utils._python_dispatch.TorchDispatchMode``.  The kernel wrappers
(``ops.kernels.cosine_vote`` / ``w8a8_matmul`` / ``w4a8_matmul``,
``ops.attention.attention`` / ``segment_attention``) are the kernels: on
the card each is one hand-written launch, on the CPU its plain version,
whose ops say nothing of the card's path.  The audit marks each
wrapper's entry and exit (a profile hook on the wrappers' code objects,
in the audit's own context manager; the wrappers are not changed) and
judges only the ops outside them.  One rule per JXA rule:

* **TXA001 host-sync** (JXA001 host-transfer) — no
  ``aten._local_scalar_dense`` / ``aten.item`` (``.item()``) or other op
  that reads a
  device value on the host (``is_nonzero``, ``equal``, ``nonzero``,
  ``masked_select``, ``unique``) outside the wrappers: the dispatch
  must return at enqueue.
* **TXA002 dequant-regression** (JXA002) — under ``int8`` and
  ``int4-pallas``, no conversion of an int8 or uint8 tensor to a float
  type outside the wrappers (the dequantize-then-matmul storage
  anti-pattern), and six quantized-matmul wrapper calls per encoder
  layer (q, k, v, attention out, MLP in, MLP out).
* **TXA003 f64-promotion** (JXA003) — no float64 tensor anywhere in the
  dispatch outside the wrappers (the W8A8 plain version accumulates its
  int8 products in f64, exactly, where the card's kernel accumulates in
  int32).
* **TXA004 missing-bucket** (JXA004) — after ``warmup`` over the serving
  specs, every expected bucket key (``("vote1", N, S)``, ``("embed",
  B, S)``, ``("many", R, N, S)``, ``("packed", B, L, K)``) is in the
  embedder's ``GraphTable``.
* **TXA005 stray-dispatch** (JXA005 stray-specialization) — one dispatch
  of every served kind adds zero eager dispatches and zero new keys
  (``GraphTable.stats``: on the CPU ``warm`` records the key and a
  dispatch at a recorded key is not eager, so the bookkeeping holds
  without a card).

The **CPU half** (``run_dispatch_audit``, the CLI's default, tier-1) runs
at ``test-tiny`` the served kinds ``consensus_confidence_tokens`` (the
reference's ``_embed_and_vote``), ``consensus_confidence_tokens_many``
(``_embed_and_vote_many``), ``embed_tokens``, ``embed_packed`` and the
consensus forward under ``int8`` and ``int4-pallas``.  The **card half**
(``card_audit``, run by ``chip_smoke.py``) takes a warmed embedder on
the card: each warmed bucket's enqueue runs under
``torch.cuda.set_sync_debug_mode("error")`` (the enqueue only: the
readiness wait is the waiter's), the TXA004/TXA005 bookkeeping holds on
the real graphs, and every kernel launch takes its route.

Env knobs (the reference's names, all optional):
``ANALYSIS_JAXPR_MODEL`` (preset, default ``test-tiny``),
``ANALYSIS_JAXPR_SPECS`` (comma list of ``NxS``, default ``4x16``),
``ANALYSIS_JAXPR_R_BUCKETS`` (comma list, default ``2``),
``ANALYSIS_JAXPR_PACKED_BUCKETS`` (comma list of ``BxLxK``, default
``1x64x8,2x64x8``; an empty value audits no packed bucket);
``ANALYSIS_SKIP_JAXPR=1`` skips the audit (the CLI honours it).

torch is imported inside the entry points, so importing ``analysis``
stays stdlib-cheap.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

from .engine import Finding

_DEFAULT_MODEL = "test-tiny"
_DEFAULT_SPECS = ((4, 16),)
_DEFAULT_R_BUCKETS = (2,)
_DEFAULT_PACKED_BUCKETS = ((1, 64, 8), (2, 64, 8))

# aten ops that read a device value on the host (a stream sync)
HOST_SYNC_OPS = {
    "_local_scalar_dense",
    "item",
    "is_nonzero",
    "equal",
    "nonzero",
    "masked_select",
    "_unique",
    "_unique2",
    "unique_consecutive",
    "unique_dim",
}
# ops that change a tensor's dtype
_CONVERT_OPS = {"_to_copy", "to", "copy_", "_copy_from", "type_as"}
QUANT_MATMULS_PER_LAYER = 6


def _env_specs() -> Tuple[Tuple[int, int], ...]:
    raw = os.environ.get("ANALYSIS_JAXPR_SPECS", "")
    if not raw.strip():
        return _DEFAULT_SPECS
    specs = []
    for part in raw.split(","):
        n, s = part.strip().lower().split("x")
        specs.append((int(n), int(s)))
    return tuple(specs)


def _env_r_buckets() -> Tuple[int, ...]:
    raw = os.environ.get("ANALYSIS_JAXPR_R_BUCKETS", "")
    if not raw.strip():
        return _DEFAULT_R_BUCKETS
    return tuple(int(p) for p in raw.split(",") if p.strip())


def _env_packed_buckets() -> Tuple[Tuple[int, int, int], ...]:
    raw = os.environ.get("ANALYSIS_JAXPR_PACKED_BUCKETS")
    if raw is None:
        return _DEFAULT_PACKED_BUCKETS
    buckets = []
    for part in raw.split(","):
        if not part.strip():
            continue
        b, l, k = part.strip().lower().split("x")
        buckets.append((int(b), int(l), int(k)))
    return tuple(buckets)


# ---------------------------------------------------------------------------
# Recording one dispatch
# ---------------------------------------------------------------------------


def kernel_wrappers() -> Dict[object, str]:
    """code object -> name, for the kernel wrappers the audit treats as
    kernels."""
    from ..ops import attention, kernels

    wrappers = (
        kernels.cosine_vote,
        kernels.w8a8_matmul,
        kernels.w4a8_matmul,
        attention.attention,
        attention.segment_attention,
    )
    return {w.__code__: w.__name__ for w in wrappers}


class OpRecord:
    """One aten op: its name, the dtypes of its tensor inputs and
    outputs, and whether it ran inside a kernel wrapper."""

    __slots__ = ("name", "in_dtypes", "out_dtypes", "in_wrapper")

    def __init__(self, name, in_dtypes, out_dtypes, in_wrapper) -> None:
        self.name = name
        self.in_dtypes = in_dtypes
        self.out_dtypes = out_dtypes
        self.in_wrapper = in_wrapper


class Recording:
    """What one recorded call ran: ``ops`` and ``wrapper_calls``."""

    def __init__(self) -> None:
        self.ops: List[OpRecord] = []
        self.wrapper_calls: Counter = Counter()


@contextlib.contextmanager
def recording():
    """Record every aten op run on this thread inside the block, and the
    kernel-wrapper calls around them; yields the ``Recording``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    rec = Recording()
    codes = kernel_wrappers()
    depth = [0]
    me = threading.get_ident()

    def profile(frame, event, arg):
        if event == "call" and frame.f_code in codes:
            depth[0] += 1
            rec.wrapper_calls[codes[frame.f_code]] += 1
        elif event == "return" and frame.f_code in codes:
            depth[0] -= 1

    def dtypes(tree):
        return tuple(
            t.dtype for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor)
        )

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if threading.get_ident() == me:
                rec.ops.append(OpRecord(
                    func.overloadpacket.__name__,
                    dtypes((args, kwargs)),
                    dtypes(out),
                    depth[0] > 0,
                ))
            return out

    previous = sys.getprofile()
    sys.setprofile(profile)
    try:
        with Mode():
            yield rec
    finally:
        sys.setprofile(previous)


def _is_float(dtype) -> bool:
    return dtype.is_floating_point


def judge(rec: Recording, label: str, symbol: str, *,
          quantized: bool = False, layers: int = 0) -> List[Finding]:
    """TXA001-003 over one recorded dispatch."""
    import torch

    path = f"dispatch:{label}"
    findings: List[Finding] = []
    f64_seen = False
    for op in rec.ops:
        if not op.in_wrapper and op.name in HOST_SYNC_OPS:
            findings.append(Finding(
                rule="TXA001", path=path, line=0, symbol=symbol,
                message=(f"`aten.{op.name}` reads a device value on the "
                         "host inside the dispatch: the dispatch path "
                         "must return at enqueue (readiness is the "
                         "waiter's)"),
            ))
        if (quantized and not op.in_wrapper and op.name in _CONVERT_OPS
                and any(d in (torch.int8, torch.uint8) for d in op.in_dtypes)
                and any(_is_float(d) for d in op.out_dtypes)):
            findings.append(Finding(
                rule="TXA002", path=path, line=0, symbol=symbol,
                message=(f"`aten.{op.name}` converts an int8/uint8 tensor "
                         "to a float type outside the quantized-matmul "
                         "wrappers: the dequantize-then-matmul "
                         "regression the fused W8A8/W4A8 kernels "
                         "replaced"),
            ))
        if (not f64_seen and not op.in_wrapper
                and torch.float64 in op.in_dtypes + op.out_dtypes):
            f64_seen = True
            findings.append(Finding(
                rule="TXA003", path=path, line=0, symbol=symbol,
                message=(f"`aten.{op.name}` touches a float64 tensor: an "
                         "f64 leak doubles every buffer and falls off "
                         "the tensor cores"),
            ))
    if quantized:
        calls = (rec.wrapper_calls["w8a8_matmul"]
                 + rec.wrapper_calls["w4a8_matmul"])
        want = QUANT_MATMULS_PER_LAYER * layers
        if calls != want:
            findings.append(Finding(
                rule="TXA002", path=path, line=0, symbol=symbol,
                message=(f"{calls} quantized-matmul wrapper call(s) in the "
                         f"forward, want {want} ({QUANT_MATMULS_PER_LAYER} "
                         f"per layer x {layers} layers): a dense layer "
                         "left the fused kernels"),
            ))
    return findings


# ---------------------------------------------------------------------------
# The served kinds
# ---------------------------------------------------------------------------


def expected_keys(embedder, specs, r_buckets, packed_buckets) -> List[tuple]:
    """The bucket keys ``embedder.warmup(specs, r_buckets,
    packed_buckets)`` must record, derived here from the bucket rules."""
    from ..models.embedder import _bucket, _seq_bucket

    keys = []
    for n, s in specs:
        s = _seq_bucket(s, embedder.max_tokens)
        keys.append(("vote1", n, s))
        keys.append(("embed", _bucket(n, embedder.MAX_DEVICE_BATCH), s))
        keys += [("many", r, n, s) for r in r_buckets if r >= 2]
    keys += [("packed", b, l, k) for b, l, k in packed_buckets]
    return keys


def served_calls(embedder, specs, r_buckets, packed_buckets, seed: int = 0):
    """[(label, symbol, thunk)]: one dispatch of every served kind at each
    warmed bucket, on inputs made from ``seed``."""
    import numpy as np

    from ..models.embedder import _seq_bucket

    rng = np.random.default_rng(seed)
    vocab = int(embedder.config.vocab_size)
    calls = []

    def rows(shape):
        ids = rng.integers(1, vocab, size=shape, dtype=np.int32)
        mask = np.ones(shape, np.int32)
        return ids, mask

    for n, s in specs:
        s = _seq_bucket(s, embedder.max_tokens)
        ids, mask = rows((n, s))
        calls.append((f"vote1(n={n},s={s})", "consensus_confidence_tokens",
                      lambda i=ids, m=mask:
                      embedder.consensus_confidence_tokens(i, m, 0.05)))
        calls.append((f"embed(n={n},s={s})", "embed_tokens",
                      lambda i=ids, m=mask: embedder.embed_tokens(i, m)))
        for r in r_buckets:
            if r < 2:
                continue
            rids, rmask = rows((r, n, s))
            calls.append((
                f"many(r={r},n={n},s={s})",
                "consensus_confidence_tokens_many",
                lambda i=rids, m=rmask:
                embedder.consensus_confidence_tokens_many(i, m, 0.05)))
    for b, l, k in packed_buckets:
        inputs = packed_inputs(embedder, b, l, k, rng)
        calls.append((f"packed(b={b},l={l},k={k})", "embed_packed",
                      lambda x=inputs: embedder.embed_packed(**x)))
    return calls


def packed_inputs(embedder, b: int, l: int, k: int, rng) -> dict:
    """A valid packed layout at (B, L, K): each row holds segments of the
    serving window end to end, ``seg_starts`` at their first tokens."""
    import numpy as np

    width = min(l, embedder.max_tokens)
    col = np.arange(l, dtype=np.int32)
    seg = col // width + 1
    starts = np.zeros((b, k), np.int32)
    n_seg = min(k, int(seg.max()))
    starts[:, :n_seg] = np.arange(n_seg, dtype=np.int32) * width
    return {
        "ids": rng.integers(1, int(embedder.config.vocab_size), size=(b, l),
                            dtype=np.int32),
        "segment_ids": np.tile(seg, (b, 1)),
        "positions": np.tile(col % width, (b, 1)),
        "seg_starts": starts,
    }


def audit_embedder(embedder, specs, r_buckets=(), packed_buckets=(),
                   tag: str = "", kinds: Optional[Sequence[str]] = None,
                   warm: bool = True) -> List[Finding]:
    """TXA001-005 over one embedder: ``warmup`` over the specs (unless
    ``warm`` is False: the caller warmed it), TXA004 on the recorded
    keys, then one recorded dispatch of every served kind (``kinds``
    restricts them by symbol), TXA001-003 on each and TXA005 on the
    bookkeeping around them."""
    from ..models import quant

    if warm:
        embedder.warmup(list(specs), list(r_buckets), list(packed_buckets))
    findings: List[Finding] = []
    stats = embedder.graph_stats()
    have = set(stats["keys"])
    from ..models.graphs import key_label

    for key in expected_keys(embedder, specs, r_buckets, packed_buckets):
        if key_label(key) not in have:
            findings.append(Finding(
                rule="TXA004", path=f"dispatch:{key_label(key)}{tag}",
                line=0, symbol="warmup",
                message=(f"bucket {key_label(key)} was not warmed: its "
                         "first request would run eagerly (and on the "
                         "card capture nothing)"),
            ))
    quantized = quant.is_quantized(embedder.model)
    layers = int(embedder.config.num_layers)
    for label, symbol, thunk in served_calls(embedder, specs, r_buckets,
                                             packed_buckets):
        if kinds is not None and symbol not in kinds:
            continue
        before = embedder.graph_stats()
        with recording() as rec:
            thunk()
        after = embedder.graph_stats()
        findings += judge(rec, label + tag, symbol, quantized=quantized,
                          layers=layers)
        eager = after["eager_dispatches"] - before["eager_dispatches"]
        new = sorted(set(after["keys"]) - set(before["keys"]))
        if eager or new or after["captures"] != before["captures"]:
            findings.append(Finding(
                rule="TXA005", path=f"dispatch:{label}{tag}", line=0,
                symbol=symbol,
                message=(f"{eager} eager dispatch(es), "
                         f"{after['captures'] - before['captures']} "
                         f"capture(s) and new keys {new} after warmup: "
                         "this kind dispatches outside the warmed "
                         "buckets"),
            ))
    return findings


def run_dispatch_audit(model: Optional[str] = None) -> List[Finding]:
    """The CPU half at the serving specs of the env knobs: the
    full-precision embedder over every served kind, then the consensus
    forward under ``int8`` and ``int4-pallas``."""
    import torch

    from ..models.embedder import TorchEmbedder

    model = model or os.environ.get("ANALYSIS_JAXPR_MODEL") or _DEFAULT_MODEL
    specs = _env_specs()
    r_buckets = _env_r_buckets()
    packed = _env_packed_buckets()
    findings: List[Finding] = []
    with torch.inference_mode():
        dense = TorchEmbedder(model, device="cpu", seed=0)
        findings += audit_embedder(dense, specs, r_buckets, packed)
        for mode in ("int8", "int4-pallas"):
            quantized = TorchEmbedder(model, device="cpu", seed=0,
                                      quantize=mode)
            findings += audit_embedder(
                quantized, specs, (), (), tag=f"@{mode}",
                kinds=("consensus_confidence_tokens",))
    return findings


# ---------------------------------------------------------------------------
# The card half
# ---------------------------------------------------------------------------


def _route_counts() -> Dict[str, Dict[str, int]]:
    from ..ops import attention, kernels

    return {
        w.__name__: dict(w.routes)
        for w in (attention.attention, attention.segment_attention,
                  kernels.cosine_vote, kernels.w8a8_matmul,
                  kernels.w4a8_matmul)
    }


def card_audit(embedder, keys: Sequence[tuple], calls, want_routes: dict,
               device: str = "cuda") -> dict:
    """The card half over a warmed embedder on the card.  ``calls`` are
    [(label, thunk)] dispatches (``served_calls`` shape) at the warmed
    buckets ``keys``.  Each thunk runs under a deferred-readiness sink
    with ``torch.cuda.set_sync_debug_mode("error")`` around the enqueue
    only; the sink is then drained off the debug mode.  ``want_routes``
    maps a wrapper name to ``{route: launches}`` that the calls must add
    (every other route of that wrapper: 0).  Returns a record with
    ``findings`` (a list of rendered strings, empty when clean)."""
    import torch

    from ..models import dispatch_seam as seam
    from ..models.graphs import key_label

    if not str(device).startswith("cuda") or not torch.cuda.is_available():
        raise RuntimeError(
            "card_audit needs a CUDA device (device="
            f"{device!r}, cuda available: {torch.cuda.is_available()}); "
            "the CPU half is run_dispatch_audit")
    findings: List[str] = []
    stats = embedder.graph_stats()
    missing = [key_label(k) for k in keys if key_label(k) not in
               set(stats["keys"])]
    for label in missing:
        findings.append(f"TXA004 dispatch:{label}: bucket not warmed")
    torch.cuda.synchronize()
    routes0 = _route_counts()
    before = embedder.graph_stats()
    syncs = []
    for label, thunk in calls:
        sink = seam.DispatchSink()
        with seam.deferred_readiness(sink):
            torch.cuda.set_sync_debug_mode("error")
            try:
                thunk()
            except RuntimeError as exc:
                syncs.append(label)
                findings.append(
                    f"TXA001 dispatch:{label}: the enqueue synchronized: "
                    f"{exc}")
            finally:
                torch.cuda.set_sync_debug_mode("default")
        for record in sink.pending:
            record.wait(record.out)
    torch.cuda.synchronize()
    after = embedder.graph_stats()
    routes1 = _route_counts()
    eager = after["eager_dispatches"] - before["eager_dispatches"]
    captures = after["captures"] - before["captures"]
    if eager or captures:
        findings.append(f"TXA005: {eager} eager dispatch(es) and "
                        f"{captures} capture(s) after warmup")
    added = {
        name: {r: routes1[name][r] - routes0[name][r] for r in routes1[name]}
        for name in routes1
    }
    for name, want in want_routes.items():
        for route, n in added[name].items():
            if n != want.get(route, 0):
                findings.append(
                    f"route: {name} took {route} {n}x, want "
                    f"{want.get(route, 0)}")
    return {
        "dispatches": len(calls),
        "keys": [key_label(k) for k in keys],
        "syncs_in_enqueue": syncs,
        "eager_dispatches": eager,
        "captures": captures,
        "replays": after["replays"] - before["replays"],
        "launches": added,
        "findings": findings,
    }
