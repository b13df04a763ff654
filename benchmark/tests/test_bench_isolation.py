"""The yardstick stands alone: the reference, the generators and the counts
import nothing of the program, and no run may hold a module of JAX or of
the JAX package (names compared whole, so the port's own name passes)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.core.modules import forbidden_loaded

BENCH = Path(__file__).resolve().parents[1]
STANDALONE = ["reference", "core/scene.py", "counts", "core/card.py", "core/trace.py",
              "core/modules.py"]


def _sources():
    for part in STANDALONE:
        p = BENCH / part
        yield from (sorted(p.rglob("*.py")) if p.is_dir() else [p])


@pytest.mark.parametrize("path", list(_sources()), ids=lambda p: str(p.relative_to(BENCH)))
def test_standalone_sources_import_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in ("vbt_tpu_torch", "vbt_tpu", "jax", "jaxlib", "flax"), n


def test_importing_the_yardstick_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.detect, benchmark.reference.track, "
            "benchmark.reference.train.step, benchmark.core.scene, benchmark.counts.flops, "
            "benchmark.counts.kernels\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('vbt_tpu_torch', 'vbt_tpu', 'jax', 'jaxlib', 'flax')]\n"
            "print(bad); sys.exit(1 if bad else 0)") % str(BENCH.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_jax_rule_compares_top_level_names_whole():
    loaded = ["vbt_tpu_torch", "vbt_tpu_torch.models", "numpy", "jax", "jax.numpy", "jaxlib",
              "flax.core", "vbt_tpu", "vbt_tpu.models", "jaxtyping", "flaxen"]
    assert forbidden_loaded(loaded) == ["flax.core", "jax", "jax.numpy", "jaxlib", "vbt_tpu",
                                        "vbt_tpu.models"]


def test_a_run_exits_nonzero_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark: no result."""
    import shutil

    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "lite0.stream",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()
