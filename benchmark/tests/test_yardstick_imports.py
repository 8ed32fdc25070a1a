"""What the harness may import: no module under ``benchmark/`` imports
JAX or the JAX package (top-level names compared whole: the port's name
begins with the JAX package's), and the reference imports nothing of the
program."""

import ast
from pathlib import Path

import pytest
import yardstick_helpers as h

BENCH = h.ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "llm_weighted_consensus_tpu"}
PORT = "llm_weighted_consensus_tpu_torch"


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob(
    "*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert PORT not in top_level_imports(path)
    assert not {n for n in top_level_imports(path)
                if n.startswith("llm_weighted")}


def test_the_names_are_compared_whole():
    assert PORT.split(".", 1)[0] not in FORBIDDEN
    assert "llm_weighted_consensus_tpu" in FORBIDDEN


def test_a_run_loads_no_jax(tmp_path):
    import subprocess
    import sys

    code = (
        "import sys, time; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import yardstick_helpers as h\n"
        "from benchmark.run import loaded_forbidden\n"
        "c = h.cell(h.COSINE, candidates=4, clients=2)\n"
        "out = h.run(c, seconds=0.5)\n"
        "assert out['correct'], out\n"
        "print(loaded_forbidden())\n" % (str(h.ROOT), str(Path(
            __file__).parent)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
