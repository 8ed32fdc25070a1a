"""A configuration, a cell and a per-layer metric added as files alone:
dropped into a copy of the benchmark's folder, they are found by name
and run, with no file of the harness edited."""

import json
import shutil
import subprocess
import sys

import yardstick_helpers as h

CELL = "tiny-bert.consensus-n8-c2"
METRIC = "answered.probe"


def make_copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(h.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    cfg = json.loads((h.ROOT / "benchmark/configs/bge-large-en.json")
                     .read_text())
    cfg.update(h.TINY, serving_dtype="float32")
    (root / "benchmark/configs/tiny-bert.json").write_text(json.dumps(cfg))
    mix = json.loads((h.ROOT / f"benchmark/workloads/{h.COSINE}.json")
                     .read_text())
    mix.update(candidates=8, senders=2, rate_per_s=20.0,
               candidate_tokens=[10, 20], prebuild_per_client=4,
               check_sample=4)
    (root / f"benchmark/workloads/{CELL}.json").write_text(json.dumps(mix))
    (root / f"benchmark/metrics/{METRIC}.py").write_text(
        "def read(r):\n    return float(len(r.completed))\n")
    bench = json.loads((h.ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "tiny-bert", "source": "https://example.org/tiny",
        "file": "benchmark/configs/tiny-bert.json", "reduced": [],
        "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tiny-bert",
                               "traffic": "consensus-n8-c2", "chips": 1,
                               "why": "test"})
    for metric in bench["end_to_end"]:
        if "workloads" in metric:
            metric["workloads"].append(CELL)
    bench["per_layer"].append({
        "name": METRIC, "unit": "requests", "better": "higher",
        "source": "program_counter", "layer": "host path",
        "moves": "answers_per_s", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, bench


def run_copy(root, trace: int) -> dict:
    code = (
        "import json, sys, time\n"
        f"sys.path[:0] = [{str(root)!r}, {str(h.ROOT)!r}]\n"
        "from benchmark import spec\n"
        "from benchmark.cell import run_cell\n"
        f"assert spec.HERE == spec.Path({str(root / 'benchmark')!r})\n"
        f"cell = spec.Spec({str(root)!r}).cell({CELL!r})\n"
        f"out = run_cell(cell, 11, 1.0, {bool(trace)}, 'cpu', time.time(),"
        " log=lambda m: None)\n"
        "print(json.dumps(out))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_new_files_are_found_and_run(tmp_path):
    root, bench = make_copy(tmp_path)
    before = {p.name: p.read_bytes() for p in (h.ROOT / "benchmark").glob(
        "*.py")}
    plain = run_copy(root, 0)
    assert plain["correct"]
    assert set(plain["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    traced = run_copy(root, 1)
    assert traced["correct"]
    assert traced["metrics"][METRIC]["unit"] == "requests"
    assert traced["metrics"][METRIC]["value"] > 0
    for name, data in before.items():
        assert (root / "benchmark" / name).read_bytes() == data
