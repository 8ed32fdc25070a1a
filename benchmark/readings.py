"""What a per-layer metric's reader reads: one ``Readings`` per traced
run, built after the window closed.  Readers live in ``metrics/``, one
file per metric, each with ``read(r: Readings) -> float | None``; a
reader that finds nothing to read returns None and the metric is left
out of the result line."""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

from . import cost, spec

_LABEL = re.compile(r"^(\w+)\(([^)]*)\)")
# the products of cuBLAS and CUTLASS, by their kernels' names
MATMUL = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|cublas", re.I)


def parse_label(label: str) -> Optional[tuple]:
    """``"many(r=8,n=64,s=128)@..."`` -> ("many", {"r": 8, ...})."""
    m = _LABEL.match(label)
    if m is None:
        return None
    args = {}
    for part in m.group(2).split(","):
        key, _, value = part.partition("=")
        if not value.strip().isdigit():
            return None
        args[key.strip()] = int(value)
    return m.group(1), args


@dataclass
class Readings:
    cfg: dict
    mix: dict
    window_s: float
    completed: list                 # records answered in the window
    latencies_ms: list
    lengths: list                   # per completed request, token counts
    before: dict                    # the program's counters at the open
    after: dict                     # ... and at the close
    trace: dict                     # trace.Trace.digest()
    port_kernels: set = field(default_factory=set)

    # -- helpers readers share ------------------------------------------------

    def delta(self, *path) -> Optional[float]:
        a, b = self.before, self.after
        for key in path:
            if not isinstance(a, dict) or not isinstance(b, dict):
                return None
            a, b = a.get(key, 0), b.get(key)
        if b is None:
            return None
        return float(b - (a or 0))

    def bucket_deltas(self) -> dict:
        """{label: dispatches in the window} from the device buckets."""
        a = self.before.get("device_buckets", {})
        b = self.after.get("device_buckets", {})
        return {k: v - a.get(k, 0) for k, v in b.items()
                if v - a.get(k, 0) > 0}

    def kernel_seconds(self, predicate) -> float:
        return sum(e - s for n, s, e in self.trace["kernels"]
                   if predicate(n)) / 1e9

    def is_port_kernel(self, name: str) -> bool:
        return any(re.search(rf"\b{k}\b", name) for k in self.port_kernels)

    def p50_ms(self) -> Optional[float]:
        lat = sorted(self.latencies_ms)
        return lat[len(lat) // 2] if lat else None

    def mfu_percent(self, over_busy: bool = False) -> Optional[float]:
        """The FLOPs the completed requests' real tokens need, over the
        window's seconds (or, ``over_busy``, the seconds the device was
        busy in it) times the bf16 peak, in percent."""
        seconds = self.trace["busy_s"] if over_busy else self.window_s
        if not self.completed or seconds <= 0:
            return None
        flops = sum(cost.request_flops(self.cfg, n) for n in self.lengths)
        return 100.0 * flops / (seconds * cost.H100_BF16_FLOPS)

    def idle_share(self) -> Optional[float]:
        w = self.trace["window_s"]
        if w <= 0 or not self.trace["device"]:
            return None
        return 1.0 - self.trace["busy_s"] / w

    def attention_roofline_percent(self) -> Optional[float]:
        """Bound time of the traced attention launches over their
        profiled time.  Each dispatch's launches and their bound come
        from the configuration's family (``attention_bound``) at the
        dispatch's bucket: its padded rows at its sequence length; the
        mix of shapes is scaled to the launches the trace holds."""
        names = [k for k in self.port_kernels if "attention" in k]
        launches = [(n, s, e) for n, s, e in self.trace["kernels"]
                    if any(re.search(rf"\b{k}\b", n) for k in names)]
        if not launches:
            return None
        family = spec.family(self.cfg["family"])
        bound, count = 0.0, 0
        for label, n in self.bucket_deltas().items():
            parsed = parse_label(label)
            if parsed is None:
                continue
            kind, a = parsed
            rows = {"vote1": a.get("n"), "embed": a.get("b"),
                    "many": a.get("r", 0) * a.get("n", 0)}.get(kind)
            if not rows or "s" not in a:
                continue
            per, k = family.attention_bound(self.cfg, rows, a["s"])
            bound += per * n
            count += k * n
        if not count:
            return None
        measured = sum(e - s for _, s, e in launches) / 1e9
        return 100.0 * (bound / count) * len(launches) / measured
