"""Find a mix's knee: the highest fixed rate the system sustains.

    python3 benchmark/sweep.py --workload <cell> --rates 6,8,10,12,14 \
        [--seconds 15] [--seed 1]

Builds the cell's system once, then offers its requests open loop at each
rate in turn (``traffic/open_loop.py`` with the mix's ``senders``) and
prints one JSON line a rate: answers completed per second, p50 and p95
from the due times, how late the generator ran, and the p50 of the last
third of the window's requests over that of the first third, which grows
past 1 where a backlog builds.  The knee is the highest rate whose
completed rate keeps up and whose backlog does not grow; a cell below it
runs at about four fifths of it, a cell above it well past it."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--rates", required=True)
    parser.add_argument("--seconds", type=float, default=15.0)
    parser.add_argument("--seed", type=int, default=1)
    args = parser.parse_args(argv)
    # the checkout's root in place of this folder: the harness's modules
    # are imported as ``benchmark.*`` only
    sys.path[0] = str(ROOT)
    import torch

    from benchmark import spec, weights
    from benchmark.cell import Session, percentile, warm
    from benchmark.system import System, concurrency
    from benchmark.traffic.requests import RequestSource

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.Spec(ROOT).cell(args.workload)
    cfg, mix = cell.cfg, dict(cell.mix)
    mix["generator"] = "open_loop"
    mix.setdefault("senders", concurrency(mix))
    state = weights.make_state(cfg, args.seed, "cuda",
                               getattr(torch, cfg["serving_dtype"]))
    system = System(cfg, mix, state, "cuda")
    source = RequestSource(mix, args.seed)
    warm(system, mix, source)
    drive = spec.generator("open_loop").drive
    try:
        for n, rate in enumerate(float(r) for r in args.rates.split(",")):
            mix["rate_per_s"] = rate
            # every rate gets requests of its own
            session = Session(system.port, mix["path"],
                              RequestSource(mix, args.seed + 1000 * (n + 1)),
                              [], args.seconds, 120.0)
            stats = drive(mix, session)
            end = session.window_end
            done = sorted((r for r in session.records
                           if r.status == 200 and r.done <= end),
                          key=lambda r: r.due)
            lat = [1e3 * (r.done - r.due) for r in done]
            third = max(1, len(lat) // 3)
            trend = (percentile(lat[-third:], 0.5)
                     / percentile(lat[:third], 0.5)) if lat else None
            print(json.dumps({
                "workload": args.workload, "rate_per_s": rate,
                "answers_per_s": len(done) / args.seconds,
                "p50_ms": percentile(lat, 0.5) if lat else None,
                "p95_ms": percentile(lat, 0.95) if lat else None,
                "backlog_trend": trend, "late_p50_ms": stats["late_p50_ms"],
                "late_max_ms": stats["late_max_ms"],
                "failed": sum(r.status != 200 for r in session.records),
                "stats": system.server.batcher.stats()["dispatches"]
                if system.server.batcher is not None else None}),
                flush=True)
            time.sleep(2.0)
    finally:
        system.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
