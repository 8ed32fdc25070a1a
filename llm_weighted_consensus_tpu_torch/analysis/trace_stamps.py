"""How far ``torch.profiler`` can be trusted to keep a kernel's record.

The profiler drops every device record whose time stamp lies outside its
window.  A kernel's record can be stamped before its own launch call, so
work that starts right at a window's edge can vanish from the trace.
This traces ``CALLS`` launches of the port's attention kernel (bge-large
shape, bf16) per trace, with the traced call starting each of
``MARGINS_MS`` in turn after the window opens, for ``SECONDS``, and
prints one JSON record: per margin the traces taken, those that lost a
launch, and the spread of stamp offsets (kernel start minus its launch
call, µs).  ``chip_smoke.py``'s ``profile_call`` keeps the 50 ms margin.

    python -m llm_weighted_consensus_tpu_torch.analysis.trace_stamps

It needs the card: without one it prints an error record and exits 2.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

SECONDS, CALLS, MARGINS_MS = 60.0, 20, (0.0, 50.0)


def stamp_offsets(path: str) -> dict:
    """``{"kernels": n, "offsets_us": [...]}`` of a Chrome trace: each
    kernel's start minus the start of the launch call of its correlation
    id (kernels whose call is not in the trace have no offset)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    calls = {ev["args"]["correlation"]: ev["ts"] for ev in events
             if ev.get("cat") == "cuda_runtime"
             and "correlation" in ev.get("args", {})}
    kernels = [ev for ev in events if ev.get("cat") == "kernel"]
    offsets = [ev["ts"] - calls[c] for ev in kernels
               if (c := ev.get("args", {}).get("correlation")) in calls]
    return {"kernels": len(kernels), "offsets_us": offsets}


def _trace(fn, margin_s: float, path: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(margin_s)
        fn()
        torch.cuda.synchronize()
        time.sleep(margin_s)
        prof.step()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print(json.dumps({"error": "no-cuda-device"}))
        return 2
    from ..ops import attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(64, 128, 16, 64, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    bias = torch.zeros(64, 128, device="cuda")

    def calls():
        for _ in range(CALLS):
            attention.attention(q, k, v, bias, 0.125)

    rows = {m: {"traces": 0, "lost": 0, "offsets_us": []}
            for m in MARGINS_MS}
    end = time.perf_counter() + SECONDS
    i = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        while time.perf_counter() < end:
            m = MARGINS_MS[i % len(MARGINS_MS)]
            _trace(calls, m / 1e3, path)
            seen = stamp_offsets(path)
            rows[m]["traces"] += 1
            rows[m]["lost"] += seen["kernels"] < CALLS
            rows[m]["offsets_us"] += seen["offsets_us"]
            i += 1
    out = {}
    for m, row in rows.items():
        offsets = sorted(row.pop("offsets_us"))
        out[f"{m:g}"] = {**row, "offset_us_min": offsets[0],
                         "offset_us_p1": offsets[len(offsets) // 100],
                         "offset_us_p50": offsets[len(offsets) // 2],
                         "offset_us_max": offsets[-1]}
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "calls": CALLS,
                      "by_margin_ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
