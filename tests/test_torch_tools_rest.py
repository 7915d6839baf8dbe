"""The port's ``tools.stress_256``, ``tools.kernel_bench`` and
``tools.scaling_bench`` on the CPU twins (``--device cpu``), at small sizes,
against the JAX package.

Bars and why:

- stress: every iteration bit-identical to the first, and the field held to
  JAX's ``make_level_set3`` on the same case at the end-to-end bars of
  tests/test_torch_sharded.py (0 sign mismatches off the surface, the band
  within rtol 5e-5 / atol 2e-6, every cell within 0.05 dx): jitted JAX
  contracts FMAs, the port rounds every operation;
- kernel_bench: the dense phi within rtol 2e-6 / atol 1e-6 of JAX's
  ``dense_distance_field`` (Pallas interpret mode, as tests/test_dense.py
  runs it), ids equal but at float64 ties (tests/test_torch_dense.py); the
  signed phi bit-equal to ``pipeline.dense_sign_core`` on the same inputs;
  the parity transport the one JAX's ``bin_mesh`` chose;
- scaling_bench: every shard count bit-equal to one shard and to the
  single-device ``make_level_set3``, and ``halo_comms_model`` for (2, 4)
  equal to JAX's dict.

Each tool refuses to run without a card unless given ``--device cpu``,
leaves ``BASELINE.json`` as it was, and imports nothing of JAX."""

import ast
import hashlib
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfgenfast_tpu as J
from sdfgenfast_tpu import mesh as jmesh_mod
from sdfgenfast_tpu.ops import dense as jdense
from sdfgenfast_tpu.parallel import sharded as jsh
import sdfgenfast_tpu_torch as P
from sdfgenfast_tpu_torch import pipeline as ppipe
from sdfgenfast_tpu_torch.grid import sizing_mode2a_proportional
from sdfgenfast_tpu_torch.tools import kernel_bench, scaling_bench, stress_256

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_dense import _assert_ids_tie  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(ROOT, "BASELINE.json")
TOOLS = (stress_256, kernel_bench, scaling_bench)
CPU = torch.device("cpu")
SURF_EPS = 1e-5

torch.set_num_threads(1)


def _sha(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _jax(mesh, grid):
    return (J.Mesh(mesh.verts, mesh.tris),
            J.GridSpec(grid.origin, grid.dx, grid.shape))


# -- stress_256 ---------------------------------------------------------------


@pytest.fixture(scope="module", params=[2, 3], ids=["ico2-dense",
                                                    "ico3-binned"])
def stress(request):
    mesh = P.icosphere(request.param, radius=1.0)
    grid = sizing_mode2a_proportional(*mesh.bounds(), 24, 1)
    before = _sha(BASELINE)
    line, phi = stress_256.run(mesh, grid, P.SDFConfig(), "cpu", 3)
    return dict(mesh=mesh, grid=grid, line=json.loads(json.dumps(line)),
                phi=phi, baseline=(before, _sha(BASELINE)))


def test_stress_iterations_bit_identical(stress):
    line = stress["line"]
    assert line["iterations"] == 3 and len(line["seconds"]) == 3
    assert line["bit_identical"] is True
    # no device metric from a CPU run
    assert line["memory"] is None and line["card"] == "cpu"
    assert line["device_ms"] == [None] * 3
    for k in ("bin_ms", "compute_ms", "copy_back_ms"):
        assert len(line[k]) == 3 and min(line[k]) >= 0
    phi = stress["phi"]
    assert phi.shape == stress["grid"].shape and np.isfinite(phi).all()
    assert line["inside_frac"] == float((phi < 0).mean())
    # the path the case takes: 320 triangles dense, 1280 binned
    assert ppipe.use_dense(P.SDFConfig(), stress["mesh"].num_tris) == (
        stress["mesh"].num_tris == 320)


def test_stress_field_meets_the_bars_against_jax(stress):
    jm, jg = _jax(stress["mesh"], stress["grid"])
    jphi = np.asarray(J.make_level_set3(jm, jg, J.SDFConfig()))
    phi, dx = stress["phi"], stress["grid"].dx
    off = np.minimum(np.abs(phi), np.abs(jphi)) > SURF_EPS
    assert (((phi < 0) != (jphi < 0)) & off).sum() == 0
    near = np.abs(jphi) < 2 * dx
    np.testing.assert_allclose(np.abs(phi)[near], np.abs(jphi)[near],
                               rtol=5e-5, atol=2e-6)
    err = np.abs(phi - jphi)
    assert err.max() <= 0.05 * dx, f"max err {err.max() / dx:.4f} dx"


def test_stress_leaves_baseline_json(stress):
    before, after = stress["baseline"]
    assert before == after


def _readings(reserved):
    return [dict(reserved=r, allocated=5, pinned_ring=64, pinned_host_cache=None)
            for r in reserved]


def test_stress_memory_plateau():
    """A reading above the second iteration's fails the run; the first two
    iterations may grow it, and a reading torch does not give is skipped."""
    flat = stress_256.plateau(_readings([10, 20, 20, 20]))
    assert flat == {"reserved": True, "allocated": True,
                    "pinned_ring": True, "pinned_host_cache": None}
    assert stress_256.plateau(_readings([10, 20, 18, 20]))["reserved"] is False
    with pytest.raises(AssertionError, match="reserved grew"):
        stress_256.plateau(_readings([10, 20, 20, 21]))
    assert stress_256.plateau(_readings([10])) == flat


# -- kernel_bench -------------------------------------------------------------


def _box():
    return P.box_mesh((3, 4, 5), (-1, -1, -1))


@pytest.fixture(scope="module")
def kbench():
    before = _sha(BASELINE)
    line, outs = kernel_bench.run(_box(), [16, 24, 64], "cpu", reps=2)
    return dict(line=json.loads(json.dumps(line)), outs=outs,
                baseline=(before, _sha(BASELINE)))


def test_kernel_bench_box_is_jax_box():
    m, jm = _box(), J.box_mesh((3, 4, 5), (-1, -1, -1))
    assert m.num_tris == 12
    np.testing.assert_array_equal(m.verts, jm.verts)
    np.testing.assert_array_equal(m.tris, jm.tris)


def test_kernel_bench_rows(kbench):
    rows = kbench["line"]["rows"]
    assert [r["nx"] for r in rows] == [16, 24, 64]
    for r in rows:
        grid = sizing_mode2a_proportional(*_box().bounds(), r["nx"], 1)
        assert r["grid"] == list(grid.shape) and r["cells"] == grid.num_cells
        assert r["tris"] == 12 and r["reps"] == 2
        assert r["dense_kernel_ms"] > 0 and r["unpack_sign_ms"] > 0
        # no device clock from a CPU run
        assert r["dense_kernel_device_ms"] is None
        assert r["unpack_sign_event_ms"] is None
    assert kbench["line"]["card"] == "cpu"


@pytest.mark.parametrize("nx", [16, 24, 64])
def test_kernel_bench_transport_is_jax_choice(kbench, nx):
    box = _box()
    grid = sizing_mode2a_proportional(*box.bounds(), nx, 1)
    jb = J.bin_mesh(*_jax(box, grid), J.SDFConfig())
    want = "packed" if jb.parity_packed is not None else "crossings"
    row = next(r for r in kbench["line"]["rows"] if r["nx"] == nx)
    assert row["transport"] == want
    # both transports occur: the crossings win from Nx 64 on
    assert want == ("crossings" if nx == 64 else "packed")


@pytest.mark.parametrize("nx", [16, 24])
def test_kernel_bench_dense_matches_jax(kbench, nx):
    box = _box()
    grid = sizing_mode2a_proportional(*box.bounds(), nx, 1)
    tv = box.verts[box.tris.astype(np.int64)]
    origin = np.asarray(grid.origin, np.float32)
    pj, tj = jdense.dense_distance_field(
        jnp.asarray(tv), jnp.asarray(origin), jnp.float32(grid.dx),
        grid_shape=grid.shape)
    phi, tid, _ = kbench["outs"][nx]
    np.testing.assert_allclose(phi.numpy(), np.asarray(pj), rtol=2e-6,
                               atol=1e-6)
    _assert_ids_tie(tv, origin, grid.dx, grid.shape, None, np.asarray(tj),
                    tid.numpy())


@pytest.mark.parametrize("nx", [16, 24, 64])
def test_kernel_bench_signed_equals_dense_sign_core(kbench, nx):
    box = _box()
    grid = sizing_mode2a_proportional(*box.bounds(), nx, 1)
    a = P.bin_mesh(box, grid, device=CPU).device.arrays
    want, want_tid = ppipe.dense_sign_core(
        a["verts"], a["tris"], a.get("parity", a.get("crossings")),
        a["origin"], grid.dx, grid_shape=grid.shape)
    phi, tid, signed = kbench["outs"][nx]
    assert torch.equal(signed.view(torch.int32), want.view(torch.int32))
    assert torch.equal(tid, want_tid)


def test_kernel_bench_leaves_baseline_json(kbench):
    before, after = kbench["baseline"]
    assert before == after


def test_kernel_bench_main_cpu(capsys):
    line = kernel_bench.main(["16", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == json.loads(json.dumps(line))
    assert any("ms/iter" in s and "dense kernel" in s for s in out)
    assert any("kernel+sign amortized" in s for s in out)
    assert out[-2] == "card: cpu"


# -- scaling_bench ------------------------------------------------------------


@pytest.fixture(scope="module")
def scaling():
    mesh = P.icosphere(2, radius=1.0)
    grid = P.GridSpec((-1.3,) * 3, 2.6 / 32, (32,) * 3)
    before = _sha(BASELINE)
    line, phi = scaling_bench.run(mesh, grid, P.SDFConfig(dense_max_tris=0),
                                  scaling_bench.device_lists(CPU), repeats=1)
    return dict(mesh=mesh, grid=grid, line=json.loads(json.dumps(line)),
                phi=phi, baseline=(before, _sha(BASELINE)))


def test_scaling_every_count_bit_equal(scaling):
    entry = scaling["line"]["published"]["device_scaling_cpu"]
    assert [r["devices"] for r in entry["rows"]] == [1, 2, 4, 8]
    assert entry["bit_equal"] is True and entry["devices"] == ["cpu"] * 8
    assert entry["rows"][0]["speedup"] == 1.0
    assert scaling["line"]["single_device"]["bit_equal_to_sharded"] is True
    # every count against the one-shard field, outside the tool
    mesh, grid = scaling["mesh"], scaling["grid"]
    cfg = P.SDFConfig(dense_max_tris=0)
    for d in (2, 8):
        dm = P.parallel.make_device_mesh(["cpu"] * d)
        sb = P.parallel.bin_mesh_sharded(mesh, grid, dm.devices.shape, cfg)
        got = P.parallel.sharded_sdf(sb, dm, verts=mesh.verts).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      scaling["phi"].view(np.int32))


def test_scaling_comms_model_equals_jax(scaling):
    entry = scaling["line"]["published"]["device_scaling_cpu"]
    assert entry["comms_model_2x4"] == jsh.halo_comms_model((32, 32, 32),
                                                            (2, 4))
    assert scaling_bench.halo_comms_model(
        (128,) * 3, (2, 4), max_hop=8) == jsh.halo_comms_model(
        (128,) * 3, (2, 4), max_hop=8)


def test_scaling_leaves_baseline_json(scaling):
    before, after = scaling["baseline"]
    assert before == after


def test_scaling_case_is_jax_case():
    mesh, grid, cfg = scaling_bench.case(128)
    jm = jmesh_mod.icosphere(4, radius=1.0)
    np.testing.assert_array_equal(mesh.verts, jm.verts)
    assert mesh.num_tris == 5120
    assert grid.shape == (128,) * 3 and grid.origin == (-1.3,) * 3
    assert grid.dx == 2.6 / 128
    assert cfg.dense_max_tris == 0 and cfg.vdt_max_hop is None
    assert scaling_bench.case(128, ladder=True)[2].vdt_max_hop == 8


def test_scaling_device_lists_cpu():
    assert scaling_bench.device_lists(CPU) == {
        "cpu": [["cpu"] * d for d in (1, 2, 4, 8)]}


# -- all three ----------------------------------------------------------------


@pytest.mark.parametrize("tool", TOOLS,
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_tools_need_cuda_unless_cpu(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main([])


@pytest.mark.parametrize("tool", TOOLS,
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_tools_import_nothing_of_jax(tool):
    """The module's imports, read from its source: relative ones stay in
    the port, absolute ones name neither JAX nor the JAX package."""
    with open(tool.__file__) as fh:
        tree = ast.parse(fh.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert names, "no imports read"
    for name in names:
        assert name.split(".")[0] not in ("jax", "jaxlib", "sdfgenfast_tpu")


def test_tools_import_without_jax():
    """The three tools import in a process where JAX and the JAX package
    cannot be imported."""
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'sdfgenfast_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import sdfgenfast_tpu_torch.tools.stress_256\n"
        "import sdfgenfast_tpu_torch.tools.kernel_bench\n"
        "import sdfgenfast_tpu_torch.tools.scaling_bench\n"
        "assert 'jax' not in sys.modules and 'sdfgenfast_tpu' not in sys.modules\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
