"""The port's measurement tools on the CPU twins (``--device cpu``):
``tools.bench``'s line and configurations against ``bench.py`` and the JAX
package, the tools' refusal to run without a card unless asked for the
CPU, ``BASELINE.json`` left as it was, and the tools' imports."""

import ast
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import sdfgenfast_tpu as J
import sdfgenfast_tpu_torch as P
from sdfgenfast_tpu import grid as jgrid_mod, mesh as jmesh_mod
from sdfgenfast_tpu_torch.grid import sizing_mode2a_proportional
from sdfgenfast_tpu_torch.testing import box36
from sdfgenfast_tpu_torch.tools import batch_bench, bench, profile_stages

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(ROOT, "BASELINE.json")

torch.set_num_threads(1)

# bench.py's detail keys (bench.py:288-301; the vs_ref pair where
# BASELINE.json has the configuration) and the line's (bench.py:280-303)
BENCH_KEYS = ("grid", "tris", "cells", "time_ms", "bin_ms", "compile_s",
              "mvoxels_per_sec", "vs_baseline_anchor")
LINE_KEYS = ("metric", "value", "unit", "vs_baseline", "detail")
PORT_KEYS = ("min_ms", "p90_ms", "n", "inside_frac", "host_ms", "device_ms",
             "copy_back_ms", "wall_ms", "peak_mem_mb", "card")


def _sha(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _tiny():
    return [("box36_16", box36(), 16, P.SDFConfig(), 5),
            ("torus100k_256", P.torus_mesh(24, 24), 24, P.SDFConfig(), 5)]


@pytest.fixture(scope="module")
def line():
    """One run on the tiny configurations, BASELINE.json's digest taken
    before and after. The torus row takes a BASELINE.json name, so that the
    reference columns are read."""
    before = _sha(BASELINE)
    out = json.loads(json.dumps(bench.run(_tiny(), "cpu", samples=2)))
    return out, before, _sha(BASELINE)


def test_line_has_bench_keys(line):
    out, _, _ = line
    for k in LINE_KEYS:
        assert k in out
    assert out["unit"] == "voxels/s" and out["device"]["platform"] == "cpu"
    assert set(out["detail"]) == {"box36_16", "torus100k_256"}
    for name, row in out["detail"].items():
        for k in BENCH_KEYS + PORT_KEYS:
            assert k in row, (name, k)
        assert row["n"] == 2 and row["min_ms"] <= row["time_ms"]
        assert row["time_ms"] <= row["p90_ms"]
        # no device metric from a CPU run
        assert row["device_ms"] is None and row["peak_mem_mb"] is None
        assert row["card"] == "cpu"
    ref = out["detail"]["torus100k_256"]
    assert "vs_ref_cpu_1t" in ref and "vs_ref_gpu_est" in ref
    assert "vs_ref_cpu_1t" not in out["detail"]["box36_16"]
    # the headline is the first row without a box256 row
    head = out["detail"]["box36_16"]
    assert out["value"] == pytest.approx(head["cells"] / head["time_ms"]
                                         * 1e3, rel=1e-3)


def test_rows_equal_jax(line):
    """cells, tris, grid and inside_frac equal the JAX package's
    make_level_set3 on the same mesh and grid."""
    out, _, _ = line
    for name, mesh, nx, _, _ in _tiny():
        grid = sizing_mode2a_proportional(*mesh.bounds(), nx, 1)
        jgrid = J.GridSpec(grid.origin, grid.dx, grid.shape)
        phi = np.asarray(J.make_level_set3(J.Mesh(mesh.verts, mesh.tris),
                                           jgrid, J.SDFConfig()))
        row = out["detail"][name]
        assert row["grid"] == list(phi.shape) == list(grid.shape)
        assert row["cells"] == phi.size and row["tris"] == len(mesh.tris)
        assert row["inside_frac"] == float((phi < 0).mean())


def test_baseline_json_unchanged(line):
    _, before, after = line
    assert before == after


def _bench_py_configs():
    """(name, nx, reps) of bench.py's `configs` list, read from its source."""
    with open(os.path.join(ROOT, "bench.py")) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "configs"
                and isinstance(node.value, ast.List)):
            return [(e.elts[0].value, e.elts[2].value, e.elts[4].value)
                    for e in node.value.elts]
    raise AssertionError("bench.py has no configs list")


def test_configs_equal_bench_py():
    want = _bench_py_configs()
    assert len(want) == 7
    assert [(n, nx, reps) for n, _, nx, reps in bench.CONFIGS] == want
    assert [c[0] for c in bench.configs({"box128", "torus100k_512"})] == [
        "box128", "torus100k_512"]


def test_configs_meshes_and_grids_equal_bench_py():
    """The meshes and grids of bench.py's configurations: box36, icosphere
    (6) and torus_mesh() at sizing_mode2a_proportional(mn, mx, nx, 1)."""
    jbox = J.box_mesh((3, 4, 5), (-1, -1, -1))
    cases = {name: (mesh, nx) for name, mesh, nx, _, _ in bench.configs()}
    box, _ = cases["box64"]
    assert box.num_tris == 36 and len(jbox.tris) == 12
    sphere, _ = cases["sphere82k_256"]
    torus, _ = cases["torus100k_512"]
    jsphere = jmesh_mod.icosphere(6, radius=1.0)
    jtorus = jmesh_mod.torus_mesh()
    np.testing.assert_array_equal(sphere.verts, jsphere.verts)
    np.testing.assert_array_equal(torus.tris, jtorus.tris)
    assert torus.num_tris == 100352
    for name, (mesh, nx) in cases.items():
        g = sizing_mode2a_proportional(*mesh.bounds(), nx, 1)
        jg = jgrid_mod.sizing_mode2a_proportional(*mesh.bounds(), nx, 1)
        assert g.shape == jg.shape and g.dx == jg.dx, name
    assert sizing_mode2a_proportional(*torus.bounds(), 256, 1).shape == (
        256, 256, 75)


@pytest.mark.parametrize("tool", [bench, profile_stages, batch_bench],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_tools_need_cuda_unless_cpu(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main([])


def test_bench_main_cpu(capsys):
    """The entry point on the CPU: one configuration by name, one JSON line
    on stdout."""
    bench.main(["box64", "--device", "cpu", "--samples", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    row = json.loads(out[0])["detail"]["box64"]
    assert row["grid"] == [64, 85, 105] and row["n"] == 1
    with pytest.raises(ValueError, match="unknown"):
        bench.main(["box65", "--device", "cpu"])
    with pytest.raises(ValueError, match="samples"):
        bench.run(bench.configs({"box64"}), torch.device("cuda"), samples=2)


def test_tools_import_no_jax():
    """The three tools import in a process where JAX and the JAX package
    cannot be imported."""
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'sdfgenfast_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import sdfgenfast_tpu_torch.tools.bench\n"
        "import sdfgenfast_tpu_torch.tools.profile_stages\n"
        "import sdfgenfast_tpu_torch.tools.batch_bench\n"
        "assert 'jax' not in sys.modules and 'sdfgenfast_tpu' not in sys.modules\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
