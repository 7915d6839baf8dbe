"""The PyTorch port's host layer against the JAX package, on the CPU.

Grid sizing, .sdf bytes, host binning (band CSR + parity transports) and the
torch device halves of the parity reconstruction must be EXACTLY the JAX
package's: they are copies of framework-free code, so any difference is a
porting bug. Also the import contract (no JAX, no nvcc needed) and the
NotImplementedError surface of the slice."""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import sdfgenfast_tpu as J
import sdfgenfast_tpu_torch as P
from sdfgenfast_tpu import grid as jgrid
from sdfgenfast_tpu.ops import sign_host as jsign
from sdfgenfast_tpu_torch import grid as pgrid
from sdfgenfast_tpu_torch import pipeline as ppipe
from sdfgenfast_tpu_torch.ops import sign_host as psign

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BOX = (np.array([-1.5, -2.0, -2.5], np.float32),
        np.array([1.5, 2.0, 2.5], np.float32))


# One intra-op thread: the suite runs in several worker processes at
# once, and a PyTorch CPU thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("mode,args", [
    ("sizing_mode1_legacy", (0.1, 1)),
    ("sizing_mode1_legacy", (0.037, 3)),
    ("sizing_mode2a_proportional", (64, 1)),
    ("sizing_mode2a_proportional", (129, 2)),
    ("sizing_mode2b_manual", (40, 50, 60, 1)),
    ("sizing_python_api", (30, None, None, None, 1)),
    ("sizing_python_api", (None, None, None, 0.07, 2)),
])
def test_grid_sizing_equal(mode, args):
    pj = getattr(jgrid, mode)(*_BOX, *args)
    pp = getattr(pgrid, mode)(*_BOX, *args)
    assert (pj.origin, pj.dx, pj.shape) == (pp.origin, pp.dx, pp.shape)


def test_sdf_bytes_identical(tmp_path):
    rng = np.random.default_rng(0)
    phi = rng.normal(size=(7, 9, 11)).astype(np.float32)
    origin, dx = (0.25, -1.5, 3.0), 0.0625
    J.save_sdf(str(tmp_path / "j.sdf"), phi, origin, dx)
    P.save_sdf(str(tmp_path / "p.sdf"), phi, origin, dx)
    assert (tmp_path / "j.sdf").read_bytes() == (tmp_path / "p.sdf").read_bytes()
    back, o2, dx2, _ = P.load_sdf(str(tmp_path / "p.sdf"))
    np.testing.assert_array_equal(back, phi)
    assert o2 == J.load_sdf(str(tmp_path / "j.sdf"))[1]


@pytest.fixture(scope="module", params=[3, 4], ids=["ico3", "ico4"])
def sphere(request):
    mesh = P.icosphere(request.param, radius=1.0, center=(0.05, -0.02, 0.03))
    mn, mx = mesh.bounds()
    return mesh, pgrid.sizing_mode2a_proportional(mn, mx, 48, 1)


@pytest.mark.parametrize("transport", ["auto", "packed", "crossings"])
def test_bin_mesh_byte_equal(sphere, transport):
    mesh, grid = sphere
    cfg_j = J.SDFConfig(dense_max_tris=0, parity_transport=transport)
    cfg_p = P.SDFConfig(dense_max_tris=0, parity_transport=transport)
    bj = J.bin_mesh(J.Mesh(mesh.verts, mesh.tris),
                    J.GridSpec(grid.origin, grid.dx, grid.shape), cfg_j)
    bp = P.bin_mesh(mesh, grid, cfg_p)
    assert bp.tiles_dim == bj.band.tiles_dim
    assert bp.seed_band == bj.seed_band
    np.testing.assert_array_equal(bp.band_csr["ids"], bj.band.active_ids)
    for key in ("pair", "off", "cnt", "ids"):
        a, b = bp.band_csr[key], bj.band_csr[key]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), key
    assert bp.band_csr["kcap"] == bj.band_csr["kcap"]
    np.testing.assert_array_equal(bp.tris, bj.tris)
    for name in ("parity_packed", "parity_crossings"):
        a, b = getattr(bp, name), getattr(bj, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


def test_parity_device_halves_equal(sphere):
    mesh, grid = sphere
    ni = grid.shape[0]
    cross = psign.crossings_host(mesh.verts, mesh.tris, grid)
    packed = psign.packed_from_crossings(cross, ni)
    a = psign.parity_from_crossings_device(torch.from_numpy(cross), ni)
    b = jsign.parity_from_crossings_device(jnp.asarray(cross), ni)
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    c = psign.unpack_parity_device(torch.from_numpy(packed), ni)
    d = jsign.unpack_parity_device(jnp.asarray(packed), ni)
    np.testing.assert_array_equal(c.numpy(), np.asarray(d))
    # both transports encode the one parity field
    np.testing.assert_array_equal(a.numpy(), c.numpy())
    assert a.dtype == c.dtype == torch.bool


def test_import_needs_no_jax_and_no_nvcc():
    """The package must import where JAX (and the JAX package) cannot, and
    build nothing at import time."""
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'sdfgenfast_tpu', 'triton'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import sdfgenfast_tpu_torch, sdfgenfast_tpu_torch.api\n"
        "import sdfgenfast_tpu_torch.ops.band_kernel, sdfgenfast_tpu_torch.ops.vdt_kernel\n"
        "import sdfgenfast_tpu_torch.ops.dense, sdfgenfast_tpu_torch.ops.geometry\n"
        "import sdfgenfast_tpu_torch.cli, sdfgenfast_tpu_torch.io.vti\n"
        "import sdfgenfast_tpu_torch.kernels.build as b\n"
        "assert 'jax' not in sys.modules and 'sdfgenfast_tpu' not in sys.modules\n"
        "assert b._lib is None\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH="/usr/bin:/bin")  # no nvcc on the path
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_require_cuda_and_backend_resolution():
    assert P.is_gpu_available() == torch.cuda.is_available()
    with pytest.raises(ValueError):
        P.platform.resolve_device("tpu")
    assert P.platform.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        P.platform.resolve_device("cpu", "cuda:0")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            P.require_cuda()
        for backend in ("auto", "gpu"):
            with pytest.raises(RuntimeError):
                P.platform.resolve_device(backend)


@pytest.mark.parametrize("cfg,tris", [
    (dict(sign_mode="device"), 1000),    # dense path, device sign
    (dict(dense_max_tris=0, far_field="eikonal"), 2000),
    (dict(dense_max_tris=0, far_field="propagate"), 2000),
    (dict(dense_max_tris=0, sign_mode="device"), 2000),
    (dict(dense_max_tris=0, vdt_max_hop=8), 2000),
    (dict(dense_max_tris=0, vdt_extra_rounds=2), 2000),
    (dict(dense_max_tris=0, tile_shape=(4, 4, 4)), 2000),
])
def test_unported_paths_raise(cfg, tris):
    with pytest.raises(NotImplementedError):
        ppipe.check_supported(P.SDFConfig(**cfg), tris)


def test_dense_mesh_raises_through_api():
    """A dense mesh (12 triangles) runs through the API on the CPU and
    matches the float64 oracle; bad arguments still raise ValueError."""
    from oracle import brute_force_sdf

    box = P.box_mesh((1.0, 2.0, 3.0))
    origin, dx, shape = (-0.5, -0.5, -0.5), 0.25, (8, 12, 16)
    assert ppipe.use_dense(P.SDFConfig(), box.num_tris)
    phi = P.generate_sdf(box.verts, box.tris, origin, dx, *shape,
                         backend="cpu")
    ref, parity = brute_force_sdf(box.verts, box.tris, origin, dx, shape,
                                  return_parity=True)
    np.testing.assert_allclose(np.abs(phi), np.abs(ref), rtol=5e-5, atol=2e-6)
    assert ((phi < 0) == parity)[np.abs(ref) > 1e-5].all()
    with pytest.raises(ValueError):
        P.generate_sdf(box.verts, box.tris, (0, 0, 0), 0.25, 8, 0, 8,
                       backend="cpu")
    with pytest.raises(ValueError):
        P.generate_sdf(np.zeros((0, 3)), box.tris, (0, 0, 0), 0.25, 8, 8, 8,
                       backend="cpu")
