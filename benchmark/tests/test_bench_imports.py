"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Top-level module names are
compared whole: the program's name begins with the JAX package's."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from benchmark.lib import cells
from benchmark.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "sdfgenfast_tpu"}


def _imports(path: str):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub: str = ""):
    root = os.path.join(cells.HERE, sub)
    for base, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        names = set(_imports(path))
        assert names <= {"torch", "numpy", "math", "__future__"}, path


def test_no_source_reads_the_jax_era_records():
    for path in _sources():
        if os.path.basename(path) == os.path.basename(__file__):
            continue
        with open(path) as fh:
            text = fh.read()
        for name in ("BASELINE", "BENCH_r0", "MULTICHIP_r0", "bench.py\""):
            assert name not in text, (path, name)


def test_a_run_loads_neither(tmp_path):
    """Run a cut-down cell in a fresh process and read its modules."""
    code = f"""
import sys, torch
sys.path.insert(0, {tiny.REPO!r})
from benchmark import run
from benchmark.tests import tiny
b = tiny.tiny_bench({str(tmp_path)!r})
line = run.run_cell(b, "sphere82k_256.generate", 5, 0.3, False,
                    torch.device("cpu"), root={str(tmp_path)!r})
assert line["attempted"] > 0
print(sorted({{m.split(".")[0] for m in sys.modules}}))
print(run.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    loaded, found = out.stdout.strip().splitlines()[-2:]
    assert found == "[]"
    assert "sdfgenfast_tpu_torch" in loaded
