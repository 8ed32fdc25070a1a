"""Shared set-up of the benchmark's CPU tests: the harness's cells cut to
a size the CPU runs in seconds (the same code paths, the plain versions
of the kernels)."""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import spec  # noqa: E402
from benchmark.cell import run_cell  # noqa: E402

COSINE = "bge-large.consensus-n64-r16"
LATENCY = "bge-large.consensus-n64-r10"
LONG = "bge-large.consensus-long-n32-r5"
RM = "deberta-v3-base.rm-n16-s512-c8"
RM_CONFIG = ROOT / "benchmark" / "configs" / "deberta-v3-base.json"
RM_MIX = ROOT / "benchmark" / "workloads" / f"{RM}.json"

TINY = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
        "intermediate_size": 128, "vocab_size": 512}


def cell(name: str = COSINE, candidates: int = 8, clients: int = 4,
         dtype: str = "float32", rate: float = 20.0, **sizes) -> spec.Cell:
    """A benchmark cell at a CPU size: the configuration's widths cut to
    ``TINY`` (or ``sizes``), fewer candidates, a small sample, a lower
    rate over fewer connections (an open loop's ``senders``, a closed
    loop's ``clients``), served in ``dtype`` (float32 by default: at
    these widths bf16's rounding is a tenth of the scores' spread)."""
    import json

    if name == RM:
        cfg = json.loads(RM_CONFIG.read_text())
        cfg["name"] = "deberta-v3-base"
        mix = json.loads(RM_MIX.read_text())
        c = spec.Cell(name, 1, cfg, mix, [], [])
    else:
        c = spec.Spec(ROOT).cell(name)
    c.cfg.update(TINY)
    c.cfg.update(sizes)
    c.cfg["serving_dtype"] = dtype
    c.mix.update(candidates=candidates, prebuild_per_client=4,
                 check_sample=6)
    if c.mix["generator"] == "open_loop":
        c.mix.update(senders=clients, rate_per_s=rate)
    else:
        c.mix.update(clients=clients)
    c.mix.setdefault("limits", {})
    return c


def run(c: spec.Cell, seed: int = 7, seconds: float = 1.5,
        trace: bool = False, **kw) -> dict:
    return run_cell(c, seed, seconds, trace, "cpu", time.time(),
                    log=lambda m: None, **kw)
