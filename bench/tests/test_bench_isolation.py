"""Nothing the benchmark runs imports JAX, the JAX package ``repro`` or
anything under ``benchmarks/``, and the references import nothing of the
program: module names are compared whole at their top level
(``repro_torch`` is not ``repro``)."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from bench.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
SOURCES = sorted(p for p in tiny.BENCH.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(tiny.BENCH)))
def test_no_forbidden_import(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN
    # nothing reads the JAX package's benchmark folder by path
    folder = "benchmarks" + "/"
    assert not [s for s in _strings(path) if folder in s]


def _strings(path):
    """String constants of the code, docstrings left out."""
    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


@pytest.mark.parametrize("path", sorted((tiny.BENCH / "reference").glob(
    "*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert "repro_torch" not in tops


DRY_RUN = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from bench.tests import tiny
for entry, model in (("round", tiny.DENSE), ("prefill", tiny.HYBRID),
                     ("decode", tiny.DENSE)):
    res, _ = tiny.run(entry, model, trace=True)
    assert res["correct"], res
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_dry_run_loads_no_forbidden_module():
    root = tiny.BENCH.parent
    code = DRY_RUN.format(root=str(root), src=str(root / "src"))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "bench" in loaded
    assert not loaded & FORBIDDEN
