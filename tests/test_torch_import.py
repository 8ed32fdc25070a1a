"""The PyTorch port stands alone: it imports neither JAX nor anything of
the JAX package, nor ``optax``/``orbax`` (its trainers are torch's), nor
``xxhash`` or ``aiohttp``, which the card's machine does not have, nor
the reference's root benches (``bench*.py``) or anything under
``tests/`` (its benches keep their own copies of what they share).

A subprocess imports every module of ``llm_weighted_consensus_tpu_torch``
(its ``bench/`` subpackage included, and ``chip_smoke.py``) with those
modules poisoned, and an AST scan shows that no file of the port names
them.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "llm_weighted_consensus_tpu_torch"
BANNED = ("jax", "jaxlib", "llm_weighted_consensus_tpu", "xxhash", "aiohttp",
          "optax", "orbax", "bench", "bench_all", "bench_attn", "bench_fwd",
          "bench_host", "bench_http", "bench_scaling", "tests", "fakes",
          "conftest", "test_learning_effect")

LWC_RULES = (
    "lwc001_swallowed_cancellation", "lwc002_orphaned_task",
    "lwc003_release_in_finally", "lwc004_contextvar_token",
    "lwc005_decimal_purity", "lwc006_blocking_in_async",
    "lwc007_envelope_kind", "lwc008_env_read_outside_config",
    "lwc009_torch_in_async", "lwc010_registry_consistency",
    "lwc011_config_readme_drift", "lwc012_prom_family_registry",
    "lwc013_blocking_readiness", "lwc014_guarded_field",
    "lwc015_lock_order", "lwc016_blocking_under_lock",
    "lwc017_frame_rebuild_in_merge_loop", "lwc018_unbounded_ingest_growth",
)

_PROBE = r"""
import importlib
import json
import pkgutil
import sys

BANNED = ("jax", "jaxlib", "llm_weighted_consensus_tpu", "xxhash", "aiohttp",
          "optax", "orbax", "bench", "bench_all", "bench_attn", "bench_fwd",
          "bench_host", "bench_http", "bench_scaling", "tests", "fakes",
          "conftest", "test_learning_effect")


class _Poison:
    def __init__(self, name):
        self.name = name

    def find_spec(self, fullname, path=None, target=None):
        if fullname == self.name or fullname.startswith(self.name + "."):
            raise ImportError(f"POISONED: the port imported {fullname}")


for banned in BANNED:
    sys.meta_path.insert(0, _Poison(banned))

import llm_weighted_consensus_tpu_torch as port

names = [port.__name__]
for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    names.append(info.name)
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
print(json.dumps({"ok": True, "modules": names, "leaked": leaked}))
"""


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_without_jax_or_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE],
        capture_output=True,
        text=True,
        timeout=300,
        cwd=str(REPO),
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["leaked"] == [], out
    # every module of the slice was imported
    for name in (
        "models.configs", "models.tokenizer", "models.loading",
        "models.layers", "models.bert", "models.convert", "models.quant",
        "models.embedder", "ops.similarity", "ops.kernels",
        "ops.attention", "ops._build", "types.embeddings",
        "serve.batcher", "serve.gateway", "serve.__main__", "serve.packing",
        "models.spm", "models.deberta", "models.reranker", "utils.native",
        "errors", "models.dispatch_seam", "models.graphs", "obs.histogram",
        "obs.phases", "ops.launches", "resilience.admission",
        "resilience.deadline", "resilience.watchdog", "serve.config",
        "serve.lifecycle", "serve.metrics", "utils.jsonutil", "types.base",
        "types.chat_request", "types.chat_response", "types.score_request",
        "types.score_response", "types.multichat_request",
        "types.multichat_response", "identity", "identity.llm",
        "identity.model", "identity.xxh3", "registry", "archive",
        "resilience.budget", "clients.sse", "clients.chat", "clients.params",
        "clients.score", "clients.multichat", "serve.chat_routes",
        "serve.fake_upstream", "utils.io", "ballot", "ballot.tree",
        "ballot.vote", "ballot.prompting", "clients.tally", "weights",
        "weights.training_table", "cache", "cache.fingerprint",
        "cache.singleflight", "cache.store", "cache.replay",
        "ops.consensus", "ops.votes", "parallel", "parallel.batch",
        "archive.rescore", "weights.learning", "serve.archive_routes",
        "obs", "obs.span", "obs.sink", "obs.propagate", "obs.quality",
        "obs.ledger", "resilience", "resilience.breaker", "resilience.hedge",
        "resilience.quorum", "resilience.faults", "resilience.memguard",
        "serve.frames", "weights.live", "train", "train.feed",
        "train.fit", "train.__main__", "resilience.meshfault", "analysis",
        "analysis.roofline", "analysis.cost", "analysis.trace_stamps",
        "analysis.engine", "analysis.rules", "analysis.concurrency",
        "analysis.concurrency_model", "analysis.witness",
        "analysis.dispatch_audit", "analysis.__main__",
        *(f"analysis.rules.{rule}" for rule in LWC_RULES),
        "serve.profiling",
        "bench", "bench.__main__", "bench.common", "bench.headline",
        "bench.fwd", "bench.attn", "bench.configs", "bench.learning",
        "bench.http", "bench.host",
        "fleet", "fleet.wire", "fleet.membership", "fleet.leases",
        "fleet.health", "fleet.faults", "fleet.client", "fleet.coordinator",
        "fleet.handlers",
    ):
        assert f"llm_weighted_consensus_tpu_torch.{name}" in out["modules"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", ""))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            yield node.args[0].value.split(".")[0], node.lineno


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(REPO))
)
def test_port_file_names_no_banned_module(path):
    bad = [
        (root, line) for root, line in _imported_roots(path)
        if root in BANNED
    ]
    assert bad == [], f"{path.relative_to(REPO)} imports {bad}"


def test_port_has_its_kernel_sources():
    csrc = PORT / "csrc"
    assert (csrc / "cosine_vote.cu").is_file()
    assert (csrc / "attention.cu").is_file()
    assert (csrc / "quant_matmul.cu").is_file()
    for name in ("cosine_vote.cu", "attention.cu", "quant_matmul.cu"):
        text = (csrc / name).read_text()
        # a hand-written kernel, bound with a plain C entry point; no
        # library kernel behind it
        assert "__global__" in text and 'extern "C"' in text
        for banned in ("cublas", "cudnn", "scaled_dot_product", "torch/",
                       "_int_mm", "cutlass"):
            assert banned not in text.lower()
    # the quantized matmuls run on the int8 tensor cores
    text = (csrc / "quant_matmul.cu").read_text()
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in text
    # the packed path's segment-masked attention has its own entry point
    assert 'extern "C" int lwc_attention_seg(' in (csrc / "attention.cu").read_text()


_LINT_PROBE = r"""
import json
import sys


class _Poison:
    def find_spec(self, fullname, path=None, target=None):
        if fullname.split(".")[0] in ("torch", "numpy", "jax"):
            raise ImportError(f"POISONED: the lint imported {fullname}")


sys.meta_path.insert(0, _Poison())
from llm_weighted_consensus_tpu_torch.analysis.__main__ import main

rc = main(["--no-jaxpr", "--no-mesh", "--json"])
print(json.dumps({"rc": rc, "torch": "torch" in sys.modules,
                  "numpy": "numpy" in sys.modules}))
"""


def test_the_lint_alone_never_imports_torch():
    """``python -m llm_weighted_consensus_tpu_torch.analysis --no-jaxpr
    --no-mesh`` runs with torch, numpy and jax poisoned, and exits 0: the lint and
    the concurrency audit are stdlib only, the package's import included
    (it sets torch's precision flags only once torch is imported)."""
    proc = subprocess.run(
        [sys.executable, "-c", _LINT_PROBE],
        capture_output=True,
        text=True,
        timeout=300,
        cwd=str(REPO),
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"rc": 0, "torch": False, "numpy": False}


def test_torch_keeps_full_precision_matmuls_once_imported():
    probe = (
        "import json, sys\n"
        "import llm_weighted_consensus_tpu_torch\n"
        "assert 'torch' not in sys.modules\n"
        "import torch\n"
        "print(json.dumps([torch.backends.cuda.matmul.allow_tf32,\n"
        "                  torch.backends.cudnn.allow_tf32,\n"
        "                  type(torch.__spec__.loader).__name__]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                          text=True, timeout=300, cwd=str(REPO),
                          env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [
        False, False, "SourceFileLoader"]
