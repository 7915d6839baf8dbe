"""The 100,352-triangle flagship torus (``torus_mesh()``) on the CPU twins,
held to the analytic torus (``testing.torus_sdf``, ``tessellation_gap``,
``torus_bars``); a smaller torus against the JAX package end to end; and
``tools.batch_bench`` on two small meshes."""

import numpy as np
import pytest
import torch

import sdfgenfast_tpu as J
import sdfgenfast_tpu_torch as P
from sdfgenfast_tpu_torch import pipeline as ppipe
from sdfgenfast_tpu_torch import testing
from sdfgenfast_tpu_torch.grid import sizing_mode2a_proportional
from sdfgenfast_tpu_torch.tools import batch_bench

CPU = torch.device("cpu")

torch.set_num_threads(1)


def _sagitta(n, R=1.0, r=0.4):
    """(R + r)(1 - cos(pi / n)) + r(1 - cos(pi / n)): the chord sagitta of
    the tube's outer circle plus the tube's own."""
    return (R + 2 * r) * (1 - np.cos(np.pi / n))


def test_torus_sdf_sign_at_known_points():
    p = torch.tensor([[0.0, 0.0, 0.0],    # the centre of the hole
                      [1.0, 0.0, 0.0],    # on the tube's axis
                      [0.0, -1.2, 0.1],   # inside the tube
                      [1.4, 0.0, 0.0],    # on the outer equator
                      [0.0, 0.6, 0.0],    # on the inner equator
                      [2.0, 0.0, 0.0],    # outside
                      [0.0, 0.0, 0.5]], dtype=torch.float64)
    s = testing.torus_sdf(p)
    assert s.dtype == torch.float64
    np.testing.assert_allclose(s.numpy(), [0.6, -0.4, np.sqrt(0.05) - 0.4,
                                           0.0, 0.0, 0.6,
                                           np.sqrt(1.25) - 0.4], atol=1e-15)
    assert (s[[0, 5, 6]] > 0).all() and (s[[1, 2]] < 0).all()
    assert testing.torus_sdf(p.float(), R=2.0, r=1.0)[0] == pytest.approx(1.0)


@pytest.mark.parametrize("n", [224, 96])
def test_tessellation_gap_within_the_sagitta(n):
    gap = testing.tessellation_gap(P.torus_mesh(n, n))
    # within the sagitta, up to float32 rounding of the vertices
    assert 0.9 * _sagitta(n) < gap <= _sagitta(n) + 1e-7


def test_full_torus_meets_the_analytic_bars():
    """torus_mesh() (100,352 triangles) at nx 32 through generate_sdf on
    the CPU: 0 sign mismatches off the gap, the band cells within gap +
    1e-5 of |s|, no cell below |s| - gap, none 0.2 dx above |s| + gap."""
    mesh = P.torus_mesh()
    assert mesh.num_tris == 100352
    grid = sizing_mode2a_proportional(*mesh.bounds(), 32, 1)
    phi = torch.from_numpy(P.generate_sdf(
        mesh.verts, mesh.tris, grid.origin, grid.dx, *grid.shape,
        backend="cpu"))
    gap = testing.tessellation_gap(mesh)
    # the band cells: the binning evaluates every cell within the seed band
    # (3 dx) exactly, and the far field never lowers a cell below exact
    exact = phi.abs() <= 3 * grid.dx
    assert exact.sum() > 1000
    bars = testing.torus_bars(phi, grid, gap, exact)
    testing.check_torus_bars("torus100k nx 32", bars, gap, grid.dx)
    assert bars["excess_dx"]["hole"] > -np.inf


def test_torus_matches_jax():
    """torus_mesh(96, 96) at 64 x 64 x 20 against the JAX package from the
    same binning: 0 sign mismatches where |phi| > 1e-5, every cell within
    0.05 dx (tests/test_torch_pipeline.py's bars), and both packages within
    the analytic bars."""
    mesh = P.torus_mesh(96, 96)
    grid = sizing_mode2a_proportional(*mesh.bounds(), 64, 1)
    assert grid.shape == (64, 64, 20)
    jm = J.Mesh(mesh.verts, mesh.tris)
    jg = J.GridSpec(grid.origin, grid.dx, grid.shape)
    jb = J.bin_mesh(jm, jg, J.SDFConfig())
    jphi = np.asarray(J.make_level_set3(jm, jg, J.SDFConfig(), binned=jb))
    csr = jb.band_csr
    binned = ppipe.binned_from_arrays(
        grid, P.SDFConfig(), tris=jb.tris, tiles_dim=jb.band.tiles_dim,
        pair=csr["pair"], off=csr["off"], cnt=csr["cnt"], ids=csr["ids"],
        kcap=csr["kcap"], parity_packed=jb.parity_packed,
        parity_crossings=jb.parity_crossings, seed_band=jb.seed_band)
    phi = P.make_level_set3(mesh, grid, P.SDFConfig(), binned, device=CPU)
    p = phi.numpy()
    a, b = np.abs(p), np.abs(jphi)
    assert int((((p < 0) != (jphi < 0)) & (np.minimum(a, b) > 1e-5)).sum()) == 0
    assert float(np.abs(p - jphi).max()) <= 0.05 * grid.dx
    gap = testing.tessellation_gap(mesh)
    for label, f in (("port", phi), ("jax", torch.tensor(jphi))):
        bars = testing.torus_bars(f, grid, gap, f.abs() <= 3 * grid.dx)
        testing.check_torus_bars(f"torus(96, 96) {label}", bars, gap,
                                 grid.dx)


def test_torus_bars_catch_faults():
    """Each bar fails on a field broken its way."""
    mesh = P.torus_mesh(24, 24)
    grid = sizing_mode2a_proportional(*mesh.bounds(), 24, 1)
    gap = testing.tessellation_gap(mesh)
    ax = [torch.as_tensor(grid.cell_positions_axis(a)) for a in range(3)]
    p = torch.stack(torch.meshgrid(*ax, indexing="ij"), dim=-1)
    s = testing.torus_sdf(p).float()
    testing.check_torus_bars("exact", testing.torus_bars(s, grid, gap), gap,
                             grid.dx)
    far = s.abs() > 0.1
    for broken, match in ((torch.where(far, -s, s), "sign"),
                          (s * 0.9, "below"),
                          (torch.where(far, s + torch.sign(s) * (
                              gap + 0.3 * grid.dx), s), "far field")):
        with pytest.raises(AssertionError, match=match):
            testing.check_torus_bars(
                "broken", testing.torus_bars(broken, grid, gap), gap, grid.dx)
    with pytest.raises(AssertionError, match="exact band"):
        near = s.abs() < 2 * grid.dx
        bars = testing.torus_bars(s + torch.sign(s) * 2 * gap, grid, gap, near)
        testing.check_torus_bars("broken", bars, gap, grid.dx)


def test_batch_bench_equal_to_sequential():
    meshes = batch_bench.jittered_spheres(2, subdivisions=3)
    assert len(meshes[0][1]) == 1280
    assert not np.array_equal(meshes[0][0], meshes[1][0])
    row = batch_bench.measure(meshes, (-1.3,) * 3, 2.6 / 32, (32, 32, 32),
                              CPU)
    assert row["batch_equals_sequential"] and row["card"] == "cpu"
    assert row["overlap_gain"] > 0 and 0 < row["inside_frac"] < 1
    # the tool's default batch: icosphere(6) with rng 0 and sigma 0.003
    v, t = batch_bench.jittered_spheres(1)[0]
    base = P.icosphere(6, radius=1.0)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        v, base.verts + rng.normal(0, 0.003, base.verts.shape).astype(
            np.float32))
