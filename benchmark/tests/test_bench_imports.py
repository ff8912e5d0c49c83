"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: every module that
``benchmark/run.py`` and ``benchmark/reference/`` import, followed
through the benchmark's own modules, compared by its whole top-level
name."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark.tests.conftest import REPO

BENCH = os.path.join(REPO, "benchmark")
NEVER = {"jax", "jaxlib", "flax", "halo2_aes_tpu"}
NOT_IN_REFERENCE = NEVER | {"halo2_aes_tpu_torch"}


def _imports(path):
    """Module names a file imports (absolute, dotted)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.append(node.module)
            out += [f"{node.module}.{a.name}" for a in node.names]
    return out


def _file_of(module):
    """The benchmark file of a ``benchmark.*`` module, else None."""
    if module.split(".")[0] != "benchmark":
        return None
    rel = os.path.join(REPO, *module.split("."))
    for cand in (rel + ".py", os.path.join(rel, "__init__.py")):
        if os.path.exists(cand):
            return cand
    return None


def _walk(start_files):
    """Every module reached from ``start_files`` through benchmark files."""
    seen_files, names = set(), set()
    todo = list(start_files)
    while todo:
        path = todo.pop()
        if path in seen_files:
            continue
        seen_files.add(path)
        for mod in _imports(path):
            names.add(mod)
            f = _file_of(mod)
            if f is not None:
                todo.append(f)
    return names, seen_files


def _py_files(d):
    return [os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs
            if f.endswith(".py") and "tests" not in r.split(os.sep)]


def test_run_and_readers_never_import_jax():
    starts = [os.path.join(BENCH, "run.py")] + _py_files(os.path.join(BENCH, "metrics"))
    names, files = _walk(starts)
    assert os.path.join(BENCH, "harness.py") in files
    assert os.path.join(BENCH, "reference", "check.py") in files
    bad = sorted(n for n in names if n.split(".")[0] in NEVER)
    assert not bad, bad


def test_reference_imports_nothing_of_the_program():
    names, files = _walk(_py_files(os.path.join(BENCH, "reference")))
    assert len(files) >= 10
    bad = sorted(n for n in names if n.split(".")[0] in NOT_IN_REFERENCE)
    assert not bad, bad


@pytest.mark.parametrize("what, never", [
    ("benchmark.reference.check", NOT_IN_REFERENCE),
    ("benchmark.harness", NEVER),
])
def test_loaded_modules(what, never):
    """The modules a fresh interpreter holds after importing ``what``."""
    code = (f"import sys; sys.path.insert(0, {REPO!r}); import {what}; "
            "print('\\n'.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300).stdout.split()
    assert not set(out) & never, set(out) & never
