"""The port's tile evaluator (``sdfgenfast_tpu_torch.ops.tiled``) against
the JAX package's XLA tile evaluator (``sdfgenfast_tpu.ops.tiled``) and
against K2's plain twin, on the CPU.

Bars and why:

- ``tri_affine_table``: rtol 2e-6 (atol 2e-6 of the largest magnitude).
  Op by op (``jax.disable_jit``) the two tables are equal; under jit
  XLA's CPU compiler contracts products and sums into FMAs and rewrites
  x / sqrt(y).
- Rows, closest points and fields: phi and closest points rtol 2e-6 (atol
  1e-6 for cells on the surface), ids equal except where the two ids'
  float64 distances tie to that bar (under 2% of the cells, K2's bar);
  closest points at a vertex foot as K2's bar allows (<= 1e-4 of the
  cells, at the same distance). The JAX package evaluates the six
  affine forms as one (C, 4) @ (4, 6K) product at ``Precision.HIGHEST``;
  the port sums four products in a fixed order (no matrix product, so no
  TF32 on the card), which rounds differently.
- At 8^3 the evaluator against K2's twin (``band_kernel.band_rows`` on CPU
  tensors), K2's bar (tests/test_torch_band.py): rtol 3e-6 / atol 1e-6,
  ids equal except at ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import point_triangle_distance_np
from sdfgenfast_tpu.grid import sizing_mode2a_proportional
from sdfgenfast_tpu.mesh import icosphere
from sdfgenfast_tpu.ops import band as jband
from sdfgenfast_tpu.ops import tiled as JT
from sdfgenfast_tpu_torch.ops import band_kernel
from sdfgenfast_tpu_torch.ops import tiled as PT
from sdfgenfast_tpu_torch.ops import vdt as PV

RTOL, ATOL = 2e-6, 1e-6

# One intra-op thread: the suite runs in several worker processes at
# once, and a PyTorch CPU thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)


def _tri_local():
    """icosphere(3)'s triangles in grid-local coordinates, the first three
    made degenerate: a point, a segment, three collinear vertices."""
    mesh = icosphere(3, radius=1.0, center=(0.03, -0.02, 0.01))
    tl = mesh.verts[mesh.tris.astype(np.int64)] + np.float32(1.3)
    tl[0] = tl[0, 0]
    tl[1, 2] = tl[1, 1]
    tl[2, 2] = 2 * tl[2, 1] - tl[2, 0]
    return tl


def test_tri_affine_table_matches_jax():
    tl = _tri_local()
    got = PT.tri_affine_table(torch.from_numpy(tl)).numpy()
    assert got.shape == (len(tl) + 1, 40)
    assert got[0, 39] == got[1, 39] == 1.0 and (got[3:-1, 39] == 0.0).all()
    with jax.disable_jit():
        eager = np.asarray(JT.tri_affine_table(jnp.asarray(tl)))
    # equal values (a sum of signed zeros may be -0.0 on one side)
    np.testing.assert_array_equal(got, eager)
    jitted = np.asarray(jax.jit(JT.tri_affine_table)(jnp.asarray(tl)))
    np.testing.assert_array_equal(got[-1], jitted[-1])  # the sentinel row
    # the collinear triangle's cross product is rounding noise, and so is
    # its degenerate flag: row 2 is left out under jit
    rows = np.r_[0:2, 3:len(tl)]
    np.testing.assert_array_equal(got[rows, 39], jitted[rows, 39])
    # a degenerate triangle's plane columns (0:12) are never read, and its
    # barycentric forms are rounding noise over a clamped determinant
    for cols, r in ((slice(0, 12), rows[2:]), (slice(12, 39), rows)):
        a, b = got[r, cols], jitted[r, cols]
        np.testing.assert_allclose(a, b, rtol=RTOL,
                                   atol=RTOL * np.abs(b).max())


def _ids_tie(tv_local, cells, dx, ids_a, ids_b):
    """Where the ids differ, both ids' float64 distances (from float32
    grid-local triangles and cell positions) tie to the phi bar."""
    mism = ids_a != ids_b
    if not mism.any():
        return 0
    assert (ids_a[mism] >= 0).all() and (ids_b[mism] >= 0).all()
    p = (cells[mism].astype(np.float32) * np.float32(dx)).astype(np.float64)
    tl = tv_local.astype(np.float64)
    a, b = ids_a[mism], ids_b[mism]
    da = point_triangle_distance_np(p, tl[a, 0], tl[a, 1], tl[a, 2])
    db = point_triangle_distance_np(p, tl[b, 0], tl[b, 1], tl[b, 2])
    np.testing.assert_allclose(da, db, rtol=RTOL, atol=ATOL,
                               err_msg="ids differ at a non-tie")
    return int(mism.sum())


@pytest.fixture(scope="module", params=[(8, 8, 8), (4, 4, 16), (4, 4, 4)],
                ids=lambda t: "x".join(map(str, t)))
def tiles_run(request):
    tile_shape = request.param
    mesh = icosphere(3, radius=1.0, center=(0.03, -0.02, 0.01))
    grid = sizing_mode2a_proportional(*mesh.bounds(), 30, 1)
    bb = jband.bin_triangles(mesh.verts, mesh.tris, grid, 3, tile_shape)
    tv = mesh.verts[mesh.tris.astype(np.int64)]
    origin = np.asarray(grid.origin, np.float32)
    dx = np.float32(grid.dx)
    # a padded slot (the sentinel tile id T) as the pipeline ships them
    T = int(np.prod(bb.tiles_dim))
    ids = np.concatenate([bb.active_ids, [T]]).astype(np.int32)
    cand = np.concatenate([bb.cand, np.zeros_like(bb.cand[:1])])
    valid = np.concatenate([bb.cand_valid, np.zeros_like(bb.cand_valid[:1])])
    kw = dict(tile_shape=tile_shape, tiles_dim=bb.tiles_dim,
              grid_shape=grid.shape, chunk=16)
    jrows = JT.tile_candidate_rows(
        jnp.asarray(tv), jnp.asarray(ids), jnp.asarray(cand),
        jnp.asarray(valid), jnp.asarray(origin), jnp.float32(dx), **kw)
    prows = PT.tile_candidate_rows(
        torch.from_numpy(tv), torch.from_numpy(ids), torch.from_numpy(cand),
        torch.from_numpy(valid), torch.from_numpy(origin), float(dx), **kw)
    jtable = JT.tri_affine_table(jnp.asarray(tv - origin))
    ptable = PT.tri_affine_table(torch.from_numpy(tv - origin))
    ckw = dict(tile_shape=tile_shape, tiles_dim=bb.tiles_dim, chunk=16)
    jcp = JT.closest_point_rows(jtable, jnp.asarray(ids), jrows[1],
                                jnp.float32(dx), **ckw)
    # the port's closest points of JAX's winners: the same cells, ids
    pcp = PT.closest_point_rows(ptable, torch.from_numpy(ids),
                                torch.from_numpy(np.array(jrows[1])),
                                float(dx), **ckw)
    # cell (i, j, k) of every row
    ntj, ntk = bb.tiles_dim[1:]
    t = ids.astype(np.int64)[:, None]
    loc = np.stack(np.meshgrid(*(np.arange(n) for n in tile_shape),
                               indexing="ij"), -1).reshape(-1, 3)
    cells = np.stack([t // (ntj * ntk), (t // ntk) % ntj, t % ntk], -1
                     ) * np.asarray(tile_shape) + loc[None]
    return dict(mesh=mesh, grid=grid, bb=bb, tv=tv, origin=origin, dx=dx,
                ids=ids, cand=cand, valid=valid, kw=kw, cells=cells,
                jrows=[np.asarray(r) for r in jrows],
                prows=[r.numpy() for r in prows],
                jcp=[np.asarray(r) for r in jcp],
                pcp=[r.numpy() for r in pcp], tile_shape=tile_shape)


def test_tile_candidate_rows_match_jax(tiles_run):
    r = tiles_run
    (jphi, jtid), (pphi, ptid) = r["jrows"], r["prows"]
    assert pphi.shape == jphi.shape == (len(r["ids"]),
                                        int(np.prod(r["tile_shape"])))
    assert ptid.dtype == np.int32
    np.testing.assert_allclose(pphi, jphi, rtol=RTOL, atol=ATOL)
    assert (ptid >= 0).mean() > 0.5 and (ptid < r["mesh"].num_tris).all()
    # as K2's bar: under 2% of the cells pick another triangle (the
    # sphere's shared vertices and edges), and only at ties
    n = _ids_tie(r["tv"] - r["origin"], r["cells"], r["dx"], ptid, jtid)
    assert n < 0.02 * ptid.size
    # the padded slot's cells evaluate nothing
    assert (ptid[-1] == -1).all()


def test_closest_point_rows_match_jax(tiles_run):
    """The closest points of JAX's winners agree to rtol 2e-6 — except at a
    handful of cells (<= 1e-4 of them, K2's bar) whose foot is a triangle
    vertex, where two edges tie and either edge's clamped projection
    rounds to another point near the vertex at the same distance."""
    r = tiles_run
    off = np.zeros(r["jcp"][0].shape, bool)
    for got, want in zip(r["pcp"], r["jcp"]):
        off |= ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    assert off.mean() <= 1e-4, f"{off.sum()} closest points differ"
    jtid = r["jrows"][1]
    assert (r["pcp"][0][jtid < 0] == PV.FAR).all()
    # |p - cp| reproduces the winner's distance, on both sides
    p = r["cells"].astype(np.float32) * r["dx"]
    has = jtid >= 0
    for cp in (r["pcp"], r["jcp"]):
        d = np.sqrt(sum((p[..., i] - cp[i]) ** 2 for i in range(3)))
        np.testing.assert_allclose(d[has], r["jrows"][0][has], rtol=3e-5,
                                   atol=ATOL)


def test_tile_candidate_field_matches_jax(tiles_run):
    r = tiles_run
    args = (r["tv"], r["ids"], r["cand"], r["valid"], r["origin"])
    jphi, jtid = JT.tile_candidate_field(
        *(jnp.asarray(a) for a in args), jnp.float32(r["dx"]), **r["kw"])
    pphi, ptid = PT.tile_candidate_field(
        *(torch.from_numpy(a) for a in args), float(r["dx"]), **r["kw"])
    jphi, jtid = np.asarray(jphi), np.asarray(jtid)
    assert pphi.shape == r["grid"].shape
    np.testing.assert_allclose(pphi.numpy(), jphi, rtol=RTOL, atol=ATOL)
    cells = np.stack(np.meshgrid(*(np.arange(n) for n in r["grid"].shape),
                                 indexing="ij"), -1)
    _ids_tie(r["tv"] - r["origin"], cells, r["dx"], ptid.numpy(), jtid)
    upper = np.float32(sum(r["grid"].shape)) * r["dx"]
    assert (pphi.numpy()[jtid < 0] == upper).all()


def test_scatter_rows_drops_sentinel_rows():
    rows = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    ids = torch.tensor([1, 4, 0], dtype=torch.int32)  # T = 4: dropped
    got = PT.scatter_rows(rows, ids, -1.0, (1, 2, 2), (2, 2, 1), (2, 3, 2))
    want = JT.scatter_rows(jnp.asarray(rows.numpy()), jnp.asarray(ids.numpy()),
                           -1.0, (1, 2, 2), (2, 2, 1), (2, 3, 2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_evaluator_at_8_cubed_matches_k2_twin():
    """K2 computes the evaluator's function at 8^3 tiles: on the same
    binning, the field, ids and closest points agree to K2's bar."""
    mesh = icosphere(3, radius=1.0, center=(0.03, -0.02, 0.01))
    grid = sizing_mode2a_proportional(*mesh.bounds(), 30, 1)
    bb = jband.bin_triangles(mesh.verts, mesh.tris, grid, 3, (8, 8, 8))
    tv = mesh.verts[mesh.tris.astype(np.int64)]
    origin = np.asarray(grid.origin, np.float32)
    dx = float(np.float32(grid.dx))
    tl = torch.from_numpy(tv - origin)
    pair, off, cnt = band_kernel.band_csr_from_binning(
        bb.cand, bb.cand_valid, len(tv))
    T = int(np.prod(bb.tiles_dim))
    rows = band_kernel.band_rows(
        tl.reshape(-1, 9), *(torch.from_numpy(a) for a in (
            pair, bb.active_ids, off, cnt)), dx, tiles_dim=bb.tiles_dim,
        grid_shape=grid.shape)
    k2 = [PT.untile_rows(x[:T], (8, 8, 8), bb.tiles_dim, grid.shape).numpy()
          for x in rows]
    ids = torch.from_numpy(bb.active_ids)
    kw = dict(tile_shape=(8, 8, 8), tiles_dim=bb.tiles_dim)
    phi_r, tid_r = PT.tile_candidate_rows(
        torch.from_numpy(tv), ids, torch.from_numpy(bb.cand),
        torch.from_numpy(bb.cand_valid), torch.from_numpy(origin), dx,
        grid_shape=grid.shape, **kw)
    cps = PT.closest_point_rows(PT.tri_affine_table(tl), ids, tid_r, dx, **kw)
    upper = float(np.float32(sum(grid.shape)) * np.float32(dx))
    phi, tid = (x.numpy() for x in PT.scatter_untile(
        phi_r, tid_r, ids, upper, grid_shape=grid.shape, **kw))
    cp = [PT.scatter_rows(r, ids, float(PV.FAR), grid_shape=grid.shape,
                          **kw).numpy() for r in cps]
    np.testing.assert_allclose(phi, k2[0], rtol=3e-6, atol=1e-6)
    cells = np.stack(np.meshgrid(*(np.arange(n) for n in grid.shape),
                                 indexing="ij"), -1)
    same = tid == k2[1]
    assert same.mean() > 0.98
    _ids_tie(tv - origin, cells, dx, tid, k2[1])
    off = np.zeros(same.shape, bool)
    for i in range(3):
        off |= same & ~np.isclose(cp[i], k2[2 + i], rtol=3e-6, atol=1e-6)
    assert off.mean() <= 1e-4, f"{off.sum()} closest points differ"
