"""The port stands alone: no module of rt_depth_map_tpu_torch/, and nothing in
chip_smoke.py, imports `jax` or the JAX package `rt_depth_map_tpu`, at the
top of a module or inside a function. Checked on the syntax tree, so an
import that only runs on the card is caught too."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "rt_depth_map_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "rt_depth_map_tpu_torch")):
        files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
    return files


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_the_walk_sees_the_port():
    files = [os.path.relpath(f, REPO) for f in _port_files()]
    assert "chip_smoke.py" in files
    assert "rt_depth_map_tpu_torch/ops/sgbm.py" in files
    assert "rt_depth_map_tpu_torch/config.py" in files
    assert len(files) > 30


@pytest.mark.parametrize("module,bad", [
    ("jax", True), ("jax.numpy", True), ("rt_depth_map_tpu", True),
    ("rt_depth_map_tpu.config", True), ("rt_depth_map_tpu_torch.config", False),
    ("torch", False), ("numpy", False)])
def test_forbidden_names(module, bad):
    assert _forbidden(module) == bad


def test_a_function_level_import_is_caught():
    tree = ast.parse("def f():\n    from rt_depth_map_tpu.calib import x\n")
    assert [m for _, m in _imported_modules(tree) if _forbidden(m)] == [
        "rt_depth_map_tpu.calib"]


def test_port_imports_neither_jax_nor_the_jax_package():
    offenders = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        offenders += [f"{os.path.relpath(path, REPO)}:{line} {mod}"
                      for line, mod in _imported_modules(tree) if _forbidden(mod)]
    assert not offenders, offenders
