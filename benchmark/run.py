"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's cards.  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the comparison read,
with its limit, also printed as the last lines of standard error.
Without CUDA, with fewer cards than the cell asks for, or with JAX or
the JAX package loaded once the window has closed, it exits non-zero
and prints no result."""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the caches of everything the program builds, at fixed paths inside the
# checkout, set before torch is imported
CACHE = ROOT / "build" / "benchmark-cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "llm_weighted_consensus_tpu")


def process_start() -> float:
    """When this process started, on the wall clock (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def gpu_state() -> str:
    """The card's clocks, power and temperature, for the log."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "power.draw,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc!r})"


def loaded_forbidden() -> list:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    import argparse
    import json

    started = process_start()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # the checkout's root, not this folder, heads the path: the
    # harness's modules are imported as ``benchmark.*`` only
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if os.path.abspath(p or ".") != here]
    from benchmark import spec
    from benchmark.cell import run_cell

    cell = spec.Spec(ROOT).cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"the cell asks for {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   started, log=log)
    log("card after the window: " + gpu_state())
    found = loaded_forbidden()
    if found:
        print(f"refused: {', '.join(found)} loaded in this process",
              file=sys.stderr)
        return 3
    print(f"check statistics: {out.pop('check_stats')}", file=sys.stderr)
    checks = out.pop("checks")
    for name, c in checks.items():
        print(f"check {name}: {c['value']} {c['is']} {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    out["checks"] = checks
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
