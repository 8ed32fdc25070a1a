"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<name>`` of ``workloads`` reads its configuration from the
configuration's ``file`` and its traffic mix from
``benchmark/workloads/<name>.json``; the mix's ``generator`` is
``benchmark/traffic/<generator>.py``; a per-layer metric ``<metric>`` is
read by ``benchmark/metrics/<metric>.py``; a configuration's ``family``
is ``benchmark/families/<family>.py``.  Adding a configuration, a family,
a cell, a mix or a metric is adding files and entries; nothing here
names one."""

from __future__ import annotations

import functools
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def generator(name: str):
    return load_module(HERE / "traffic" / f"{name}.py",
                       f"benchmark_traffic_{name}")


def reader(metric: str):
    return load_module(HERE / "metrics" / f"{metric}.py",
                       "benchmark_metric_" + metric.replace(".", "_"))


@functools.cache
def family(name: str):
    """The module of a configuration's ``family``, loaded once."""
    return load_module(HERE / "families" / f"{name}.py",
                       "benchmark_family_" + name.replace(".", "_"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    mix: dict
    end_to_end: list
    per_layer: list


class Spec:
    def __init__(self, root: Path):
        self.root = Path(root)
        with open(self.root / "BENCHMARK.json", encoding="utf-8") as f:
            self.data = json.load(f)

    def cell(self, name: str) -> Cell:
        cells = {w["name"]: w for w in self.data["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; known: "
                           + ", ".join(sorted(cells)))
        entry = cells[name]
        configs = {c["name"]: c for c in self.data["configs"]}
        conf = configs[entry["config"]]
        with open(self.root / conf["file"], encoding="utf-8") as f:
            cfg = json.load(f)
        cfg["name"] = conf["name"]
        with open(HERE / "workloads" / f"{name}.json", encoding="utf-8") as f:
            mix = json.load(f)
        return Cell(
            name=name, chips=int(entry["chips"]), cfg=cfg, mix=mix,
            end_to_end=[m for m in self.data["end_to_end"]
                        if _applies(m, name)],
            per_layer=[m for m in self.data["per_layer"]
                       if _applies(m, name)])
