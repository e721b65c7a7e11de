"""No module of the benchmark imports JAX or the JAX package: every import
statement under `fvbench/`, by its top-level name compared whole
(`fastvocoder_tpu_torch` begins with `fastvocoder_tpu` and is allowed)."""

import ast
import os

import pytest

from fvbench.registry import HERE

BANNED = {"jax", "jaxlib", "flax", "optax", "fastvocoder_tpu"}


def _sources():
    for root, _, files in os.walk(HERE):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_import(path):
    for mod in _imports(path):
        assert mod.split(".")[0] not in BANNED, f"{path} imports {mod}"


def test_the_scan_sees_the_program_import():
    mods = {m.split(".")[0] for m in _imports(os.path.join(HERE, "program.py"))}
    assert "fastvocoder_tpu_torch" in mods


def test_no_jax_era_files_read():
    for path in _sources():
        with open(path) as f:
            text = f.read()
        for name in ("bench.py", "BENCH_", "MULTICHIP_", "vocbench"):
            assert name not in text or path.endswith("test_fvbench_imports.py"), (path, name)
