"""A configuration, a cell and a per-layer metric added as files alone:
dropped into a copy of the benchmark's folder, they are found by name
and run, with no file of the harness edited.  So is a new family: its
module under ``families/``, its reference under ``reference/``, a
configuration and a cell."""

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


def run_copy(root, trace: int, cell: str = CELL) -> dict:
    code = (
        "import json, sys, time\n"
        f"sys.path[:0] = [{str(root)!r}, {str(h.ROOT)!r}]\n"
        "from benchmark import spec\n"
        "from benchmark.cell import run_cell\n"
        f"assert spec.HERE == spec.Path({str(root / 'benchmark')!r})\n"
        f"cell = spec.Spec({str(root)!r}).cell({cell!r})\n"
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


TOY_CELL = "toy.consensus-n8-c2"

# A BERT encoder under a family of its own, written as a new architecture
# would be: its weights drawn tensor by tensor in the served type, the
# port's loader fed one host tensor at a time, and its reference reading
# the served state, widened a layer at a time.
TOY_FAMILY = '''
"""The toy family: a BERT encoder that never holds its whole state in
float32, on the device or on the host."""

from collections.abc import Mapping

import torch

from benchmark.families import bert, common
from benchmark.reference import toy as reference
from benchmark.reference import vote
from benchmark.reference.wordpiece import WordPiece


def make_state(cfg, seed, device, dtype):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    state = {}
    for name, shape in bert.shapes(cfg):
        kind = common.layer_norm_kind(name)
        if kind == "normal":
            state[name] = (torch.randn(shape, generator=gen, device=device)
                           .mul_(cfg["init_std"]).to(dtype))
        else:
            state[name] = torch.full(shape, float(kind == "one"),
                                     device=device, dtype=dtype)
    return state


class HostView(Mapping):
    """The state as the port's loader reads it: each tensor copied to
    the host in float32 when it is read."""

    def __init__(self, state):
        self.state = state

    def __getitem__(self, name):
        return self.state[name].detach().to("cpu", torch.float32)

    def __contains__(self, name):
        return name in self.state

    def __iter__(self):
        return iter(self.state)

    def __len__(self):
        return len(self.state)


def build(cfg, state, device, dtype, quantize):
    from llm_weighted_consensus_tpu_torch.models import bert as port_bert
    from llm_weighted_consensus_tpu_torch.models.embedder import (
        TorchEmbedder)

    config = bert.port_config(cfg)
    model = port_bert.from_hf_state_dict(HostView(state), config,
                                         dtype=dtype, device=device)
    return TorchEmbedder(cfg["name"], model=model, config=config,
                         tokenizer=bert.port_tokenizer(cfg), dtype=dtype,
                         device=device, quantize=quantize), None


def reference_tokenizer(cfg):
    return WordPiece(cfg["vocab"]["tokens"])


def max_tokens(cfg):
    return cfg["max_position_embeddings"]


def reference_state(cfg, state, device):
    return state


def reference_scores(cfg, ref_state, ids, mask, device):
    return vote.cosine_scores(reference.sentence_vectors(ref_state, cfg,
                                                         ids, mask))


def request_flops(cfg, lengths):
    return bert.request_flops(cfg, lengths)


def attention_bound(cfg, rows, s):
    return bert.attention_bound(cfg, rows, s)


def control(cfg):
    return "int8"
'''

TOY_REFERENCE = '''
"""The toy family's reference: ``reference/bert.py`` over the served
state, widened to float32 one layer at a time."""

from collections.abc import Mapping

import torch

from benchmark.reference import bert

WIDENED = []


def layer_of(name):
    parts = name.split(".")
    return ".".join(parts[:3]) if parts[:2] == ["encoder", "layer"] else ""


class LayerByLayer(Mapping):
    """A read of a tensor widens its layer's tensors to float32 and drops
    the layer widened before."""

    def __init__(self, state):
        self.state, self.layer, self.held = state, None, {}

    def __getitem__(self, name):
        layer = layer_of(name)
        if layer != self.layer:
            self.held = {k: v.float() for k, v in self.state.items()
                         if layer_of(k) == layer}
            self.layer = layer
            WIDENED.append(len(self.held))
        return self.held[name]

    def __iter__(self):
        return iter(self.state)

    def __len__(self):
        return len(self.state)


def sentence_vectors(state, cfg, ids, mask):
    return bert.sentence_vectors(LayerByLayer(state), cfg, ids, mask)
'''


def test_a_new_family_is_found_and_run(tmp_path):
    root, bench = make_copy(tmp_path)
    harness = {p.relative_to(root): p.read_bytes()
               for p in (root / "benchmark").rglob("*") if p.is_file()}
    (root / "benchmark/families/toy.py").write_text(TOY_FAMILY)
    (root / "benchmark/reference/toy.py").write_text(TOY_REFERENCE)
    cfg = json.loads((root / "benchmark/configs/tiny-bert.json").read_text())
    cfg.update(family="toy", reference="benchmark/reference/toy.py",
               serving_dtype="bfloat16")
    (root / "benchmark/configs/toy.json").write_text(json.dumps(cfg))
    mix = json.loads((root / f"benchmark/workloads/{CELL}.json").read_text())
    (root / f"benchmark/workloads/{TOY_CELL}.json").write_text(
        json.dumps(mix))
    bench["configs"].append({
        "name": "toy", "source": "https://example.org/toy",
        "file": "benchmark/configs/toy.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": TOY_CELL, "config": "toy",
                               "traffic": "consensus-n8-c2", "chips": 1,
                               "why": "test"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if {CELL, h.COSINE} & set(metric.get("workloads", [])):
            metric["workloads"].append(TOY_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    plain = run_copy(root, 0, TOY_CELL)
    assert plain["correct"], plain["checks"]
    assert plain["checks"]["checked"]["value"] >= 1
    traced = run_copy(root, 1, TOY_CELL)
    assert traced["correct"], traced["checks"]
    assert traced["metrics"]["mfu_bf16.load"]["value"] > 0
    for rel, data in harness.items():
        assert (root / rel).read_bytes() == data, rel
