"""Nothing under ``ghs_bench/`` imports JAX or the JAX package (compared by
whole top-level name: the system's own name begins with that package's),
and the plain reference imports nothing of the system."""

import ast
import os
import subprocess
import sys

from ghs_bench import harness

PORT = "distributed_ghs_implementation_tpu_torch"


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
            for alias in node.names:
                yield f"{node.module}.{alias.name}"


def _sources():
    for root, dirs, files in os.walk(harness.BENCH_DIR):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_module_imports_jax_or_the_jax_package():
    found = []
    for path in _sources():
        for name in _imports(path):
            if name.split(".", 1)[0] in harness.FORBIDDEN_MODULES:
                found.append((os.path.relpath(path, harness.ROOT), name))
    assert not found


def test_the_whole_name_decides():
    assert PORT.split(".", 1)[0] not in harness.FORBIDDEN_MODULES
    assert PORT.startswith("distributed_ghs_implementation_tpu")


def test_the_reference_imports_nothing_of_the_system():
    path = os.path.join(harness.BENCH_DIR, "reference.py")
    tops = {name.split(".", 1)[0] for name in _imports(path)}
    assert tops <= {"__future__", "typing", "numpy", "torch"}
    code = ("import sys; import ghs_bench.reference, ghs_bench.graphs, ghs_bench.stats; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, check=True,
                         capture_output=True, text=True).stdout
    loaded = set(eval(out))
    assert PORT not in loaded and not loaded & set(harness.FORBIDDEN_MODULES)


def test_the_guard_sees_a_forbidden_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "distributed_ghs_implementation_tpu.x", object())
    assert "distributed_ghs_implementation_tpu" in harness.forbidden_modules()
