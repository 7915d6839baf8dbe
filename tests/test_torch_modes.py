"""The port's non-default far fields end to end on the CPU (plain twins):
``far_field="propagate"`` and ``"eikonal"``, the capped (``vdt_max_hop``)
and flat (``vdt_extra_rounds``) jump-flood ladders, and a band tile other
than 8^3 under the default pyramid, through ``make_level_set3``, against
the JAX package and the float64 oracle (``generate_sdf`` and the vertex
gradient: tests/test_torch_modes_api.py).

Both packages run from identical host state (``binned_from_arrays`` builds
the port's Binned from the JAX Binned's arrays), on a box and on
icosphere(3) (1280 triangles, above the dense cap) at the grids of
tests/test_pipeline.py. Bars and why:

- 0 sign mismatches wherever |phi| > 1e-5; the band (|phi| < 2 dx) at rtol
  5e-5 (atol 2e-6), the golden band bar.
- Every cell within 0.05*dx of the JAX package's field: the exact modes'
  far fields are jump floods whose near-tie donor choices may differ (the
  JAX package's CPU path evaluates with FMAs contracted under jit, and at
  8^3 its band comes from its tile evaluator where the port runs K2's
  twin); propagate's plane scans may settle in another fixed point after a
  tie. Eikonal: rtol 1e-5, a Jacobi relaxation of the same band.
- Against the float64 oracle: tests/test_pipeline.py's
  ``_check_against_oracle`` bars (band rtol 2e-5, never below the true
  distance, far field < 0.1*dx, signs) for every mode but eikonal, which
  keeps that file's eikonal bar (< 2*dx).
"""

import numpy as np
import pytest
import torch

import sdfgenfast_tpu as J
from sdfgenfast_tpu.mesh import icosphere as j_icosphere
import sdfgenfast_tpu_torch as P
from oracle import brute_force_sdf
from sdfgenfast_tpu_torch import pipeline as ppipe
from sdfgenfast_tpu_torch.ops import vdt_kernel

CPU = torch.device("cpu")
SURF_EPS = 1e-5

# One intra-op thread: the suite runs in several worker processes at
# once, and a PyTorch CPU thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

ROUTES = {
    "propagate": dict(far_field="propagate"),
    "eikonal": dict(far_field="eikonal"),
    "capped": dict(vdt_max_hop=4),
    "flat": dict(vdt_extra_rounds=2),
    "tiles4x4x16": dict(tile_shape=(4, 4, 16)),
}


def _box():
    return (J.box_mesh((3, 4, 5), (-1, -1, -1)),
            J.GridSpec((-1.5, -1.5, -1.5), 0.5, (14, 16, 18)))


def _sphere():
    return (j_icosphere(3, radius=1.0, center=(0.05, -0.03, 0.06)),
            J.GridSpec((-1.5, -1.5, -1.5), 0.15, (20, 20, 20)))


MESHES = {"box": _box, "sphere": _sphere}


def _carry(jb, grid, cfg):
    """The port's Binned from the JAX Binned's arrays."""
    kw = dict(tris=jb.tris, parity_packed=jb.parity_packed,
              parity_crossings=jb.parity_crossings, seed_band=jb.seed_band,
              tiles_dim=jb.band.tiles_dim, tile_shape=jb.band.tile_shape,
              active_ids=jb.band.active_ids, cand=jb.band.cand,
              cand_valid=jb.band.cand_valid)
    if jb.band_csr is not None:
        kw.update({k: jb.band_csr[k] for k in ("pair", "off", "cnt", "ids",
                                               "kcap")})
    return ppipe.binned_from_arrays(grid, cfg, **kw)


_ORACLE = {}


def _oracle(mesh_name, mesh, grid):
    """brute_force_sdf (signed, parity) of a mesh, once per module."""
    if mesh_name not in _ORACLE:
        _ORACLE[mesh_name] = brute_force_sdf(
            mesh.verts, mesh.tris, grid.origin, grid.dx, grid.shape,
            return_parity=True)
    return _ORACLE[mesh_name]


@pytest.fixture(scope="module", params=[(m, r) for m in MESHES
                                        for r in ROUTES],
                ids=lambda p: "-".join(p))
def mode_run(request):
    mesh_name, route = request.param
    jmesh, jgrid = MESHES[mesh_name]()
    # the box's 12 triangles would take the dense path in exact mode
    kw = dict(ROUTES[route], dense_max_tris=0)
    jcfg, pcfg = J.SDFConfig(**kw), P.SDFConfig(**kw)
    jb = J.bin_mesh(jmesh, jgrid, jcfg)
    jphi, jtid = J.make_level_set3(jmesh, jgrid, jcfg, binned=jb,
                                   return_tid=True)
    mesh = P.Mesh(jmesh.verts, jmesh.tris)
    grid = P.GridSpec(jgrid.origin, jgrid.dx, jgrid.shape)
    binned = _carry(jb, grid, pcfg)
    launches = vdt_kernel.round_phase.launches
    phi, tid = P.make_level_set3(mesh, grid, pcfg, binned, device=CPU,
                                 return_tid=True)
    assert vdt_kernel.round_phase.launches == launches  # no CUDA launch
    ref, parity = _oracle(mesh_name, mesh, grid)
    return dict(route=route, mesh=mesh, grid=grid, cfg=pcfg, jb=jb,
                binned=binned, jphi=np.asarray(jphi), jtid=np.asarray(jtid),
                phi=phi.numpy(), tid=tid.numpy(), ref=ref, parity=parity)


def test_mode_signs_and_band_match_jax(mode_run):
    r = mode_run
    phi, jphi = r["phi"], r["jphi"]
    assert phi.shape == jphi.shape == r["grid"].shape and phi.dtype == np.float32
    assert np.isfinite(phi).all()
    off_surface = np.minimum(np.abs(phi), np.abs(jphi)) > SURF_EPS
    mism = ((phi < 0) != (jphi < 0)) & off_surface
    assert mism.sum() == 0, f"{mism.sum()} sign mismatches"
    near = np.abs(jphi) < 2 * r["grid"].dx
    np.testing.assert_allclose(np.abs(phi)[near], np.abs(jphi)[near],
                               rtol=5e-5, atol=2e-6)


def test_mode_values_match_jax(mode_run):
    r = mode_run
    if r["route"] == "eikonal":
        np.testing.assert_allclose(r["phi"], r["jphi"], rtol=1e-5, atol=1e-6)
        # the band's ids (ties may differ); -1 beyond it
        np.testing.assert_array_equal(r["tid"] >= 0, r["jtid"] >= 0)
        return
    err = np.abs(r["phi"] - r["jphi"])
    assert err.max() <= 0.05 * r["grid"].dx, \
        f"max err {err.max() / r['grid'].dx:.4f} dx"
    assert r["tid"].min() >= 0 and r["tid"].max() < r["mesh"].num_tris


def test_mode_matches_oracle(mode_run):
    r = mode_run
    phi, ref, dx = r["phi"], r["ref"], r["grid"].dx
    off_surface = np.abs(ref) > SURF_EPS
    assert ((phi < 0) == r["parity"])[off_surface].all()
    err = np.abs(phi) - np.abs(ref)
    if r["route"] == "eikonal":
        assert np.abs(err).max() < 2 * dx  # tests/test_pipeline.py's bar
        return
    near = np.abs(ref) < 2 * dx
    np.testing.assert_allclose(np.abs(phi)[near], np.abs(ref)[near],
                               rtol=2e-5, atol=2e-5 * dx)
    assert err.min() > -1e-4 * dx - 1e-6
    assert err.max() < 0.1 * dx


def test_mode_own_binning_equals_carried_over(mode_run):
    """The port's bin_mesh builds what the route reads, byte-equal to the
    JAX package's (prune=False and the seed band exact_band in the
    propagate/eikonal modes), so the field above is the port's own."""
    r = mode_run
    own = P.bin_mesh(r["mesh"], r["grid"], r["cfg"])
    jb = r["jb"]
    assert own.seed_band == jb.seed_band
    assert own.tiles_dim == jb.band.tiles_dim
    assert own.tile_shape == jb.band.tile_shape
    if ppipe.reads_csr(r["cfg"]):
        assert own.active_ids is None
        for k in ("pair", "off", "cnt", "ids"):
            assert own.band_csr[k].tobytes() == jb.band_csr[k].tobytes(), k
    else:
        assert own.band_csr is None
        for k in ("active_ids", "cand", "cand_valid"):
            a, b = getattr(own, k), getattr(jb.band, k)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    np.testing.assert_array_equal(own.tris, jb.tris)
    for k in ("parity_packed", "parity_crossings"):
        a, b = getattr(own, k), getattr(jb, k)
        assert (a is None) == (b is None), k
        assert a is None or a.tobytes() == b.tobytes(), k
