"""The readings that set a cell's limits: the program's compared numbers
on many seeds, and the control's on a few, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 101-112 \
        --control-seeds 201-204 [--seconds 4]

Each seed is a whole run of the cell (its weights, its server, its
warm-up, a short window at the cell's own load, the reference's
comparison against a generous limit) whose compared numbers are printed
as one JSON line.  The control is the program with the path its
configuration's family names switched on (the family's ``control``: for
BERT and DeBERTa the port's int8 path, W8A8 for every dense layer of
the encoder), the precision under the bf16 that the
configurations state.  The benchmark's own runs never run it."""

from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seeds_of(text: str) -> list:
    """``"1-3,7"`` -> [1, 2, 3, 7]; ``""`` -> []."""
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=4.0)
    args = parser.parse_args(argv)
    # the checkout's root in place of this folder: the harness's modules
    # are imported as ``benchmark.*`` only
    sys.path[0] = str(ROOT)
    import torch

    from benchmark import spec
    from benchmark.cell import run_cell

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cfg = spec.Spec(ROOT).cell(args.workload).cfg
    control = spec.family(cfg["family"]).control(cfg)
    runs = [("program", "none", s) for s in seeds_of(args.seeds)] + [
        ("control", control, s) for s in seeds_of(args.control_seeds)]
    for side, quantize, seed in runs:
        cell = spec.Spec(ROOT).cell(args.workload)
        cell.mix["limits"] = {name: float("inf") for name in (
            "score_gap", "score_rms", "score_rel_rms")}
        out = run_cell(cell, seed, args.seconds, False, "cuda", time.time(),
                       quantize=quantize,
                       log=lambda m: print(m, file=sys.stderr, flush=True))
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({
            "workload": args.workload, "side": side, "seed": seed,
            "checks": {k: v["value"] for k, v in out["checks"].items()},
            "answers_per_s": out["metrics"].get("answers_per_s", {}).get(
                "value"),
            "allocated_after": torch.cuda.memory_allocated()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
