"""The PyTorch port's binned exact slice, end to end on the CPU (plain
twins), against the JAX package and the reference binary's golden.

Both packages run from identical host state (``binned_from_arrays`` builds
the port's Binned from the JAX Binned's arrays). Bars: zero sign mismatches
wherever |phi| > 1e-5, every cell within 0.05*dx (the JAX package's CPU path
evaluates the band with its XLA tile evaluator, not the Pallas kernel, and
its pyramid rounds contract differently, so near-tie donor choices may
differ). Against the golden: the bars of tests/test_parity_golden.py."""

import os

import numpy as np
import pytest
import torch

import sdfgenfast_tpu as J
import sdfgenfast_tpu_torch as P
from sdfgenfast_tpu_torch import pipeline as ppipe
from sdfgenfast_tpu_torch.grid import sizing_mode2a_proportional, sizing_python_api
from sdfgenfast_tpu_torch.io import sdf_io

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")


# One intra-op thread: the suite runs in several worker processes at
# once, and a PyTorch CPU thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)


def _jax_run(mesh, grid, transport):
    cfg = J.SDFConfig(dense_max_tris=0, parity_transport=transport)
    jmesh = J.Mesh(mesh.verts, mesh.tris)
    jgrid = J.GridSpec(grid.origin, grid.dx, grid.shape)
    jb = J.bin_mesh(jmesh, jgrid, cfg)
    phi, tid = J.make_level_set3(jmesh, jgrid, cfg, binned=jb, return_tid=True)
    return jb, np.asarray(phi), np.asarray(tid)


def _from_jax(jb, grid, cfg):
    csr = jb.band_csr
    return ppipe.binned_from_arrays(
        grid, cfg, tris=jb.tris, tiles_dim=jb.band.tiles_dim,
        pair=csr["pair"], off=csr["off"], cnt=csr["cnt"], ids=csr["ids"],
        kcap=csr["kcap"], parity_packed=jb.parity_packed,
        parity_crossings=jb.parity_crossings, seed_band=jb.seed_band)


def _sphere():
    mesh = P.icosphere(3, radius=1.0, center=(0.05, -0.02, 0.03))
    mn, mx = mesh.bounds()
    return mesh, sizing_mode2a_proportional(mn, mx, 40, 1)


def _torus():
    # flat in z: the grid is (46, 46, 20), so the pyramid runs permuted
    mesh = P.torus_mesh(24, 24, R=1.0, r=0.35)
    mn, mx = mesh.bounds()
    return mesh, sizing_python_api(mn, mx, nx=44)


@pytest.fixture(scope="module", params=[
    ("sphere", "auto"), ("sphere", "packed"), ("torus", "auto")],
    ids=lambda p: "-".join(p))
def slice_run(request):
    name, transport = request.param
    mesh, grid = _sphere() if name == "sphere" else _torus()
    jb, jphi, jtid = _jax_run(mesh, grid, transport)
    cfg = P.SDFConfig(dense_max_tris=0, parity_transport=transport)
    binned = _from_jax(jb, grid, cfg)
    phi, tid = P.make_level_set3(mesh, grid, cfg, binned, device=CPU,
                                 return_tid=True)
    return dict(mesh=mesh, grid=grid, cfg=cfg, jphi=jphi, jtid=jtid,
                phi=phi.numpy(), tid=tid.numpy())


def test_slice_signs_match_jax(slice_run):
    phi, jphi = slice_run["phi"], slice_run["jphi"]
    assert phi.shape == jphi.shape == slice_run["grid"].shape
    off_surface = np.minimum(np.abs(phi), np.abs(jphi)) > 1e-5
    mism = ((phi < 0) != (jphi < 0)) & off_surface
    assert mism.sum() == 0, f"{mism.sum()} sign mismatches"


def test_slice_values_match_jax(slice_run):
    dx = slice_run["grid"].dx
    assert np.isfinite(slice_run["phi"]).all()
    err = np.abs(slice_run["phi"] - slice_run["jphi"])
    assert err.max() <= 0.05 * dx, f"max err {err.max() / dx:.4f} dx"


def test_slice_tids_valid(slice_run):
    tid = slice_run["tid"]
    assert tid.dtype == np.int32
    assert tid.min() >= 0 and tid.max() < slice_run["mesh"].num_tris
    # ids may differ where several triangles tie (shared edges and
    # vertices, medial cells); the distances agree (test above)
    assert (tid == slice_run["jtid"]).mean() > 0.9


def test_slice_own_binning_equals_carried_over(slice_run):
    """bin_mesh in the port produces the state binned_from_arrays carries
    over, so the field is bit-identical."""
    phi = P.make_level_set3(slice_run["mesh"], slice_run["grid"],
                            slice_run["cfg"], device=CPU).numpy()
    np.testing.assert_array_equal(phi.view(np.int32),
                                  slice_run["phi"].view(np.int32))


def test_golden_sphere_64_via_api():
    """The reference binary's full 64-class golden (icosphere(3), 1280
    triangles: the binned path) through generate_sdf on the CPU twins."""
    entry = {"mesh": "icosphere.stl", "golden": "sphere_stl_64_mode2a.sdf"}
    verts, tris, bounds = P.load_mesh(os.path.join(HERE, "resources",
                                                   entry["mesh"]))
    grid = sizing_mode2a_proportional(np.asarray(bounds[0], np.float32),
                                      np.asarray(bounds[1], np.float32), 64, 1)
    golden, gmin, _ = sdf_io.read_sdf(os.path.join(HERE, "goldens",
                                                   entry["golden"]))
    assert golden.shape == grid.shape
    np.testing.assert_allclose(grid.bounds_min, gmin,
                               atol=2e-6 * max(abs(gmin).max(), 1))
    phi = P.generate_sdf(verts, tris, grid.origin, grid.dx, *grid.shape,
                         backend="cpu")
    assert phi.dtype == np.float32 and phi.shape == grid.shape
    surf = np.minimum(np.abs(phi), np.abs(golden)) < 1e-5
    mism = ((phi < 0) != (golden < 0)) & ~surf
    assert mism.sum() == 0, f"{mism.sum()} sign mismatches"
    near = np.abs(golden) < 2 * grid.dx
    np.testing.assert_allclose(np.abs(phi)[near], np.abs(golden)[near],
                               rtol=5e-5, atol=2e-6)
    err = np.abs(np.abs(phi) - np.abs(golden))
    assert err.max() < 0.2 * grid.dx, f"far field {err.max() / grid.dx:.3f} dx"


def test_generate_from_mesh_cpu_metadata():
    mesh = P.icosphere(3)
    sdf, meta = P.generate_from_mesh(mesh.verts, mesh.tris, nx=20,
                                     backend="cpu")
    assert sdf.shape[0] == 22 and meta["backend"] == "cpu"
    assert np.isfinite(sdf).all() and (sdf < 0).any() and (sdf > 0).any()
    # the cell nearest the centre is inside, about one radius deep
    c = np.unravel_index(np.argmin(sdf), sdf.shape)
    assert abs(sdf[c] + 1.0) < 2 * meta["dx"]


def test_binned_from_arrays_validates_parity():
    mesh, grid = _sphere()
    b = P.bin_mesh(mesh, grid, P.SDFConfig(dense_max_tris=0))
    kw = dict(tris=b.tris, tiles_dim=b.tiles_dim, **b.band_csr)
    with pytest.raises(ValueError):
        ppipe.binned_from_arrays(grid, b.config, **kw)
    with pytest.raises(ValueError):
        ppipe.binned_from_arrays(grid, b.config, **kw,
                                 parity_packed=np.zeros(1, np.uint8),
                                 parity_crossings=np.zeros(1, np.int16))
