"""The device trace of the measured window: ``torch.profiler`` over CPU
and CUDA activity, read as raw events.

``Trace.digest()`` gives the device intervals (kernels, copies and
sets), the kernels by name, the host ops, ``busy_s`` (the union of the
device intervals), ``window_s`` (the profiled span; every interval is
clipped to it, on the wall clock the profiler stamps events with) and the
``breakdown`` the result line carries: the ten device operations that
took the most time, and the idle time between device operations grouped
by the host op that covered most of each gap."""

from __future__ import annotations

import re
import time
from pathlib import Path

import numpy as np

# gaps longer than this are attributed one by one; the rest are summed
ATTRIBUTED_GAPS = 400


def port_kernel_names(package_dir: Path) -> set:
    """The kernels the program writes by hand: every ``__global__``
    function under its ``csrc/`` (read as text, not imported)."""
    names = set()
    for path in sorted(package_dir.glob("csrc/*.cu*")):
        text = path.read_text(errors="replace")
        names.update(re.findall(
            r"__global__\s+(?:__launch_bounds__\([^)]*\)\s+)?void\s+"
            r"(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
            text))
    return names


def union_seconds(intervals: list) -> float:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


def gaps_of(intervals: list, lo: int, hi: int) -> list:
    """[(start, end)] ns where no device interval runs, inside [lo, hi]."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


class Trace:
    def __init__(self, device: str):
        self.device = device
        self.prof = None

    def start(self) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.t0 = time.time_ns()

    def stop(self) -> None:
        self.t1 = time.time_ns()
        self.prof.stop()

    def digest(self) -> dict:
        results = self.prof.profiler.kineto_results
        device, host = [], []
        lo, hi = self.t0, self.t1
        for ev in results.events():
            # clipped to the window: the stop waits for the device, and
            # work queued before the start may run inside it
            start = max(ev.start_ns(), lo)
            end = min(ev.start_ns() + ev.duration_ns(), hi)
            if end <= start:
                continue
            kind = str(ev.device_type()).rsplit(".", 1)[-1]
            if kind == "CUDA":
                device.append((ev.name(), start, end))
            elif kind == "CPU":
                host.append((ev.name(), start, end))
        intervals = [(s, e) for _, s, e in device]
        kernels = [d for d in device
                   if not d[0].startswith(("Memcpy", "Memset"))]
        by_name = {}
        for name, s, e in device:
            by_name[name] = by_name.get(name, 0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        window_s = (hi - lo) / 1e9
        gaps = self._attribute(gaps_of(intervals, lo, hi), host)
        return {
            "device": device, "kernels": kernels, "host": host,
            "busy_s": union_seconds(intervals), "window_s": window_s,
            "breakdown": {
                "device_ops": [[n[:200], t / 1e9] for n, t in top],
                "idle_gaps": gaps,
            },
        }

    @staticmethod
    def _attribute(gaps: list, host: list) -> list:
        """Idle seconds grouped by the host op that covers most of each
        of the longest gaps; the shorter gaps summed as one entry."""
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])
        long, short = gaps[:ATTRIBUTED_GAPS], gaps[ATTRIBUTED_GAPS:]
        names = [n for n, _, _ in host]
        starts = np.array([s for _, s, _ in host], dtype=np.int64)
        ends = np.array([e for _, _, e in host], dtype=np.int64)
        spans = ends - starts
        totals = {}
        for g0, g1 in long:
            label = "no profiled host op"
            if len(starts):
                cover = np.minimum(ends, g1) - np.maximum(starts, g0)
                best = int(np.lexsort((spans, -cover))[0])
                if cover[best] > 0:
                    label = names[best]
            totals[label] = totals.get(label, 0) + (g1 - g0)
        if short:
            totals["gaps shorter than the longest "
                   f"{ATTRIBUTED_GAPS}"] = sum(e - s for s, e in short)
        ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
        return [[n[:200], t / 1e9] for n, t in ranked]
