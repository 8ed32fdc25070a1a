"""Where the host's time of a ``/consensus`` request goes, on the card.

    python3 scripts/host_split.py --out build/host_split.json \\
        [--cells CELL,...] [--seeds N,...] [--seconds 20] \\
        [--capture-cell CELL] [--capture-ms 10000] [--cpu]

Runs in one process through the benchmark's own ``run_cell``
(``benchmark/cell.py``), with the port's phase counters
(``obs/phases.py``) read around each window:

1. each cell of ``--cells`` traced, once per seed: the result line's
   per-layer metrics, each phase's sum per request over the window, the
   mean door-to-response time (the ``http:/consensus`` series), and the
   program's own device busy time (the union of its dispatches'
   launch-to-ready intervals inside the profiled window) beside the
   profiler's ``busy_s`` and the device's idle between operations inside
   a dispatch;
2. ``--capture-cell`` untraced, for each seed once plainly and once with
   a ``POST /v1/profile`` capture of ``--capture-ms`` starting 3 s into
   the window (``PROFILE_DIR`` under ``build/``, every thread; each trace
   is deleted once read): the p50 of the requests
   due under the capture against the same requests' without one, and
   from the capture's Chrome trace the device idle time under each
   ``lwc.*`` range name, with the threads that left them;
3. the time of one phase scope with no profiler, and under one.

Writes everything to ``--out`` and a summary to standard output.
``--cpu`` rehearses it at a tiny size on the CPU (nothing it prints is a
device number).
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import statistics
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "benchmark-cache"
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("CUDA_CACHE_PATH", str(CACHE / "cuda"))
sys.path.insert(0, str(ROOT))

from benchmark import cell as bench_cell  # noqa: E402
from benchmark import spec, system, trace  # noqa: E402
from llm_weighted_consensus_tpu_torch.obs import phases  # noqa: E402

R10 = "bge-large.consensus-n64-r10"
LONG = "bge-large.consensus-long-n32-r5"
TINY = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
        "intermediate_size": 128, "vocab_size": 512}
CAPTURE_DELAY_S = 3.0
# device idle shorter than this, between two device operations, lies
# inside a dispatch (kernel to kernel); a longer gap lies between two
INNER_GAP_NS = 2_000_000


class Probe:
    """What one run leaves beside its result line: the counters at the
    window's open and close, the profiled window on the host clock and
    its digest, the records, and a ``/v1/profile`` capture when one is
    asked for."""

    def __init__(self, capture_ms: float = 0.0) -> None:
        self.capture_ms = capture_ms
        self.counters = []
        self.window = [None, None]
        self.records = []
        self.capture = None
        self.window_start = None
        self.digest = None


PROBE = Probe()


def install_hooks(profile_dir: str) -> None:
    counters = system.System.counters
    start, stop = trace.Trace.start, trace.Trace.stop
    digest = trace.Trace.digest
    record = bench_cell.Session.record
    open_window = bench_cell.Session.open_window
    warmup_env = system.warmup_env

    def counters_hook(self):
        out = counters(self)
        series = dict(self.server.metrics.series_items()).get(
            "http:/consensus")
        PROBE.counters.append({
            "batcher": out["batcher"],
            "http": ((series.hist.sum, series.hist.count)
                     if series is not None else (0.0, 0)),
        })
        if len(PROBE.counters) == 1 and PROBE.capture_ms:
            threading.Thread(target=capture, args=(self.port,),
                             daemon=True).start()
        return out

    def start_hook(self):
        start(self)
        PROBE.window[0] = time.perf_counter()

    def stop_hook(self):
        PROBE.window[1] = time.perf_counter()
        stop(self)

    def digest_hook(self):
        out = digest(self)
        PROBE.digest = out
        return out

    def record_hook(self, req, due, sent, done, status, body):
        PROBE.records.append((due - self.window_start, done - due, status))
        return record(self, req, due, sent, done, status, body)

    def open_hook(self):
        open_window(self)
        PROBE.window_start = self.window_start

    system.System.counters = counters_hook
    trace.Trace.start, trace.Trace.stop = start_hook, stop_hook
    trace.Trace.digest = digest_hook
    bench_cell.Session.record = record_hook
    bench_cell.Session.open_window = open_hook
    system.warmup_env = lambda cfg, mix: dict(warmup_env(cfg, mix),
                                              PROFILE_DIR=profile_dir)


def capture(port: int) -> None:
    time.sleep(CAPTURE_DELAY_S)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/profile",
                 body=json.dumps({"duration_ms": PROBE.capture_ms}),
                 headers={"content-type": "application/json"})
    resp = conn.getresponse()
    body = resp.read()
    t1 = time.perf_counter()
    conn.close()
    PROBE.capture = {"status": resp.status, "body": body.decode(),
                     "sent": t0 - PROBE.window_start,
                     "returned": t1 - PROBE.window_start}


def cut(c: spec.Cell, cpu: bool) -> spec.Cell:
    if cpu:
        c.cfg.update(TINY, serving_dtype="float32")
        c.mix.update(candidates=8, senders=2, rate_per_s=10.0,
                     prebuild_per_client=4, check_sample=4)
    return c


def run(cell_name: str, seed: int, seconds: float, traced: bool, cpu: bool,
        capture_ms: float = 0.0) -> dict:
    global PROBE
    PROBE = Probe(capture_ms)
    c = cut(spec.Spec(ROOT).cell(cell_name), cpu)
    out = bench_cell.run_cell(c, seed, seconds, traced,
                              "cpu" if cpu else "cuda", time.time(),
                              log=lambda m: print(m, file=sys.stderr,
                                                  flush=True))
    before, after = PROBE.counters[0], PROBE.counters[-1]
    requests = (after["batcher"]["requests"]["consensus"]
                - before["batcher"]["requests"]["consensus"])
    split = {}
    for p, row in after["batcher"]["phases"].items():
        b = before["batcher"]["phases"][p]
        count = row["count"] - b["count"]
        split[p] = {"ms_per_request": ((row["sum_ms"] - b["sum_ms"]) / requests
                                       if requests else None),
                    "count": count}
    http_sum = after["http"][0] - before["http"][0]
    http_n = after["http"][1] - before["http"][1]
    result = {"cell": cell_name, "seed": seed, "traced": traced,
              "correct": out["correct"], "metrics": out["metrics"],
              "device": out["device"], "requests": requests,
              "phases": split,
              "door_to_response_ms": http_sum / http_n if http_n else None}
    if traced:
        lo, hi = PROBE.window
        # the intervals of earlier runs lie outside this window
        intervals = phases.aggregator().device_intervals()
        clipped = [(max(s, lo), min(e, hi)) for s, e in intervals
                   if e > lo and s < hi]
        program = phases._union_ms(clipped)
        profiled = out["device"]["busy_s"]
        result["busy_check"] = {
            "program_busy_s": program, "profiler_busy_s": profiled,
            "window_s": out["device"]["window_s"],
            "difference_share_of_window": (program - profiled)
            / out["device"]["window_s"],
            "dispatches": len(clipped), **inner_gaps(PROBE.digest)}
    lat = sorted(ms for _, ms, status in PROBE.records if status == 200)
    result["p50_ms_all"] = 1e3 * lat[len(lat) // 2] if lat else None
    result["records"] = PROBE.records
    result["capture"] = PROBE.capture
    return result


def inner_gaps(digest) -> dict:
    """The device's idle inside dispatches: the gaps under
    ``INNER_GAP_NS`` between the profiled device operations, and the
    operations' count."""
    ops = sorted((s, e) for _, s, e in digest["device"])
    gaps, end = [], None
    for s, e in ops:
        if end is not None and s > end:
            gaps.append(s - end)
        end = e if end is None else max(end, e)
    inner = [g for g in gaps if g < INNER_GAP_NS]
    return {"device_ops": len(ops), "inner_gaps": len(inner),
            "inner_gap_s": sum(inner) / 1e9}


def p50_between(records, lo: float, hi: float):
    lat = sorted(ms for due, ms, status in records
                 if status == 200 and lo <= due < hi)
    return (1e3 * lat[len(lat) // 2], len(lat)) if lat else (None, 0)


def read_capture(path: str) -> dict:
    """Device idle time under each ``lwc.*`` range of a Chrome trace,
    with the ranges' count, total time and threads."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    names = {}
    device, ranges = [], []
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[(ev.get("pid"), ev.get("tid"))] = ev["args"].get("name")
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        s, d = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((s, s + d))
        elif (ev.get("name", "").startswith("lwc.")
              and cat != "gpu_user_annotation"):
            # the host's range; its image on the stream (the device work
            # launched inside it) is left out
            ranges.append((ev["name"], s, s + d, (ev.get("pid"),
                                                  ev.get("tid"))))
    device.sort()
    merged = []
    for s, e in device:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = [s for s, _ in merged]

    def busy_in(lo: float, hi: float) -> float:
        import bisect

        i = max(0, bisect.bisect_right(starts, lo) - 1)
        total = 0.0
        while i < len(merged) and merged[i][0] < hi:
            total += max(0.0, min(hi, merged[i][1]) - max(lo, merged[i][0]))
            i += 1
        return total

    out = {}
    for name, s, e, thread in ranges:
        row = out.setdefault(name, {"count": 0, "ms": 0.0, "idle_ms": 0.0,
                                    "threads": set()})
        row["count"] += 1
        row["ms"] += (e - s) / 1e3
        row["idle_ms"] += (e - s - busy_in(s, e)) / 1e3
        row["threads"].add(names.get(thread) or str(thread[1]))
    for row in out.values():
        row["threads"] = sorted(row["threads"])
    span = ((max(e for _, e in merged) - min(s for s, _ in merged)) / 1e6
            if merged else 0.0)
    return {"ranges": out, "device_busy_s": sum(e - s for s, e in merged)
            / 1e6, "device_span_s": span}


def scope_cost(cuda: bool) -> dict:
    """ns per phase scope (one observation, untraced) with no profiler,
    and under a profiler of every thread as ``/v1/profile`` starts it;
    and a bare ``record_function`` with no profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from llm_weighted_consensus_tpu_torch.serve.profiling import _all_threads

    def per_scope(n: int) -> float:
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with phases.phase("scope_cost", (None,)):
                pass
        return (time.perf_counter_ns() - t0) / n

    def bare(n: int) -> float:
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with torch.profiler.record_function("lwc.scope_cost"):
                pass
        return (time.perf_counter_ns() - t0) / n

    per_scope(2000)
    off = statistics.median(per_scope(100_000) for _ in range(3))
    unguarded = statistics.median(bare(20_000) for _ in range(3))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts, experimental_config=_all_threads())
    prof.start()
    try:
        on = statistics.median(per_scope(20_000) for _ in range(3))
    finally:
        prof.stop()
    return {"ns_per_scope_off": off, "ns_per_scope_profiled": on,
            "ns_record_function_unguarded_off": unguarded,
            "profile_all_threads": _all_threads() is not None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--cells", default=f"{R10},{LONG}")
    ap.add_argument("--seeds", default="2147483901")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--capture-cell", default=R10)
    ap.add_argument("--capture-ms", type=float, default=10000.0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    if not args.cpu:
        import torch

        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
    profile_dir = str(ROOT / "build" / "host-split-profiles")
    os.makedirs(profile_dir, exist_ok=True)
    install_hooks(profile_dir)
    report = {"traced": [], "capture": [], "scope_cost": None}
    for name in filter(None, args.cells.split(",")):
        for seed in seeds:
            r = run(name, seed, args.seconds, True, args.cpu)
            r.pop("records")
            report["traced"].append(r)
            print(json.dumps({k: r[k] for k in (
                "cell", "seed", "correct", "metrics", "phases",
                "door_to_response_ms", "busy_check")}), flush=True)
    if args.capture_cell:
        lo = CAPTURE_DELAY_S
        hi = lo + args.capture_ms / 1e3
        for seed in seeds:
            pair = {}
            for mode, ms in (("plain", 0.0), ("captured", args.capture_ms)):
                done = set(os.listdir(profile_dir))
                r = run(args.capture_cell, seed, args.seconds, False,
                        args.cpu, capture_ms=ms)
                files = sorted(set(os.listdir(profile_dir)) - done)
                p50, n = p50_between(r["records"], lo, hi)
                pair[mode] = {"p50_ms_under_capture": p50, "requests": n,
                              "p50_ms_all": r["p50_ms_all"],
                              "door_to_response_ms":
                                  r["door_to_response_ms"],
                              "metrics": r["metrics"],
                              "phases": r["phases"],
                              "capture": r["capture"]}
                if files:
                    path = os.path.join(profile_dir, files[-1])
                    pair[mode]["trace_mb"] = os.path.getsize(path) / 2**20
                    pair[mode]["lwc_ranges"] = read_capture(path)
                    os.remove(path)
            report["capture"].append({"seed": seed, **pair})
            print(json.dumps({"seed": seed, **pair}, default=str),
                  flush=True)
    report["scope_cost"] = scope_cost(not args.cpu)
    print(json.dumps(report["scope_cost"]), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
