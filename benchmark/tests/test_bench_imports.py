"""Nothing the benchmark runs may load JAX or the JAX package, and the
reference loads nothing of the program."""

import ast
import os
import subprocess
import sys
from pathlib import Path

from benchmark.harness.guard import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def test_guard_compares_whole_top_level_names():
    assert forbidden_modules({"rt_depth_map_tpu_torch": 1, "rt_depth_map_tpu_torch.ops": 1,
                              "jaxtyping": 1, "flaxen": 1, "numpy": 1}) == []
    assert forbidden_modules({"jax.numpy": 1, "rt_depth_map_tpu.ops.sgbm": 1, "flax": 1,
                              "jaxlib": 1}) == ["flax", "jax", "jaxlib", "rt_depth_map_tpu"]


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_benchmark_source_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "rt_depth_map_tpu"}, path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "rt_depth_map_tpu_torch" not in _imports(path), path
    code = ("import sys; import benchmark.reference.frame; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120).stdout
    loaded = set(eval(out))
    assert not loaded & {"rt_depth_map_tpu_torch", "rt_depth_map_tpu", "jax", "jaxlib", "flax"}


def test_run_exits_without_a_card_and_prints_no_result():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "bm-1080p-d288.rig1", "--seed", "2147483999", "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == "" or not proc.stdout.strip().splitlines()[-1].startswith("{")
